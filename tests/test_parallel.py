'''
Multi-chip path tests on the virtual 8-device CPU mesh: the shard_map fused
step must agree with the single-device fused step (same physics, psum'd
histograms), and per-shard RNG streams must differ.
'''

import numpy as np
import jax
import pytest

from optics_design_workbench import benchmarks
from optics_design_workbench.parallel import makeMesh
from optics_design_workbench.tracing import fused


def test_sharded_step_matches_single_device():
  mesh = makeMesh(nDevices=8)
  N = 8 * 512
  stepSharded, hist0, meta = benchmarks.makeBenchStep(
      raysPerStep=N, maxIntersections=4, mesh=mesh, bins=(32, 32))
  histS, countersS = stepSharded(jax.random.PRNGKey(0), hist0)
  segS, hitsS = int(countersS['segments']), int(countersS['hits'])
  assert segS >= N                      # at least one segment per ray
  assert hitsS > 0.9 * N                # nearly all rays reach the detector
  total = float(histS['counts'].sum())
  assert total == hitsS

  # single-device step on the same scene: statistics agree within MC error
  stepSingle, hist1, _ = benchmarks.makeBenchStep(
      raysPerStep=N, maxIntersections=4, mesh=None, bins=(32, 32))
  hist1, counters1 = stepSingle(jax.random.PRNGKey(0), hist1)
  hits1 = int(counters1['hits'])
  assert abs(hitsS - hits1) < 0.05 * N

  # centroid of the detector spot agrees
  def centroid(h):
    H = np.asarray(h['counts'])[0]
    n = H.sum()
    ys, xs = np.indices(H.shape)
    return (H * ys).sum() / n, (H * xs).sum() / n
  cS, c1 = centroid(histS), centroid(hist1)
  assert abs(cS[0] - c1[0]) < 1.5 and abs(cS[1] - c1[1]) < 1.5


def test_sharded_steps_accumulate():
  mesh = makeMesh(nDevices=8)
  N = 8 * 256
  step, hist, meta = benchmarks.makeBenchStep(
      raysPerStep=N, maxIntersections=4, mesh=mesh, bins=(32, 32))
  hist, c1 = step(jax.random.PRNGKey(1), hist)
  t1 = float(hist['counts'].sum())
  hist, c2 = step(jax.random.PRNGKey(2), hist)
  t2 = float(hist['counts'].sum())
  # accumulation without shard-count double counting
  assert t2 == t1 + int(c2['hits'])


def test_per_shard_rng_streams_differ():
  mesh = makeMesh(nDevices=8)
  scene = benchmarks.buildSourceDetectorScene()
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  gen = scene.lightSources()[0].deviceGenerator()
  from jax import shard_map
  from jax.sharding import PartitionSpec as P

  def sample(keys):
    key = jax.random.fold_in(keys[0], jax.lax.axis_index('rays'))
    batch = gen(key, 64)
    return batch['directions']

  sharded = shard_map(sample, mesh=mesh, in_specs=(P('rays'),),
                      out_specs=P('rays'), check_vma=False)
  keys = jax.random.split(jax.random.PRNGKey(5), 8)
  out = np.asarray(sharded(keys))            # (8*64, 3)
  shards = out.reshape(8, 64, 3)
  # different shards draw different samples
  assert not np.allclose(shards[0], shards[1])


def test_fans_shard_with_padding_matches_single_device(tmp_path):
  '''Deterministic fan batches whose ray count does not divide the mesh
  (4 fans x 33 rays = 132, 132 % 8 = 4) are padded with throwaway rays and
  sharded statically over all 8 devices; the recorded hit set must equal
  the unsharded run exactly (the analog of the reference's
  initial-conditions queue, results_store.py:679-738).'''
  import glob
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  from optics_design_workbench import simulation
  from optics_design_workbench.simulation import results_store as RS

  def makeScene(path):
    scene = Scene(label='fanshard', path=path)
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Detector',
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
        placements=[T.translation(0, 0, 100)]))
    scene.addSource(PointSource(
        Label='Source', PowerDensity='exp(-theta^2/0.01)',
        ThetaDomain='0, pi/4', Wavelength=532., Fans=4, RaysPerFan=33,
        ThetaResolutionNumericMode='2e4'))
    scene.addSimulationSettings(
        RaysPerIteration=1000, MaxIntersections=5, MaxRayLength=1000,
        EnableStoreSingleShotData=True,
        StoreHitFanIndex=True, StoreHitRayIndex=True)
    return scene

  def loadHits(runPath):
    cols = None
    for folder in glob.glob(f'{runPath}/source-*/object-*'):
      for f in RS.resultFilePaths(folder, 'hits'):
        data = RS.loadResultFile(f)
        if cols is None:
          cols = {k: [v] for k, v in data.items() if v.ndim > 0}
        else:
          for k in cols:
            cols[k].append(data[k])
    out = {k: np.concatenate(v) for k, v in cols.items()}
    n = len(out['points'])
    return {k: v for k, v in out.items() if len(v) == n}

  single = loadHits(simulation.runSimulation(
      makeScene(str(tmp_path / 'single')), 'fans', store=True))
  sharded = loadHits(simulation.runSimulation(
      makeScene(str(tmp_path / 'sharded')), 'fans', store=True,
      mesh=makeMesh(nDevices=8)))
  assert len(sharded['points']) == len(single['points'])

  def sortRows(cols):
    order = np.lexsort((cols['rayIndex'], cols['fanIndex']))
    return {k: v[order] for k, v in cols.items()}

  s1, s2 = sortRows(single), sortRows(sharded)
  np.testing.assert_allclose(s2['points'], s1['points'], atol=1e-5)
  np.testing.assert_array_equal(s2['fanIndex'], s1['fanIndex'])
  np.testing.assert_array_equal(s2['rayIndex'], s1['rayIndex'])


_DCN_WORKER = '''
import json, os, sys

import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_cpu_collectives_implementation', 'gloo')

sys.path.insert(0, sys.argv[3])
from optics_design_workbench.parallel import mesh as M
from optics_design_workbench.parallel import sharded
from optics_design_workbench import benchmarks
from optics_design_workbench.tracing import fused

M.initDistributed(coordinatorAddress=sys.argv[1],
                  numProcesses=2, processId=int(sys.argv[2]))
import numpy as np
assert len(jax.devices()) == 8, jax.devices()
mesh = M.makeMesh()
scene = benchmarks.buildLensMirrorScene(tmpdir=os.environ['DCN_TMP'])
device, info = scene.compile()
device['powerTol'] = 1e-6
src = scene.lightSources()[0]
histSpec = fused.makeHistogramSpec(device, info,
                                   bounds=(-60., 60., -60., 60.),
                                   bins=(32, 32))
step = sharded.makeShardedFusedStep(mesh, device, src.deviceGenerator(),
                                    histSpec, raysPerStep=8 * 256,
                                    maxIntersections=4, maxRayLength=1e6,
                                    distTol=1e-4)
h = fused.initHistograms(histSpec)
h, c = step(jax.random.PRNGKey(0), h)

def fetch(x):
  return (np.asarray(x.addressable_data(0))
          if hasattr(x, 'addressable_data') else np.asarray(x))

print(json.dumps(dict(segments=int(fetch(c['segments'])),
                      hits=int(fetch(c['hits'])),
                      checksum=float(fetch(h['counts']).sum()))))
'''


def test_two_process_dcn_matches_single_process(tmp_path):
  '''Multi-host (DCN) execution: two OS processes, each with 4 forced CPU
  devices, join one 8-device mesh via parallel.mesh.initDistributed
  (jax.distributed + gloo CPU collectives) and run the sharded fused step.
  Both processes must see the identical psum-replicated result, and it
  must equal the same step on a single-process 8-device mesh (the shard
  streams depend only on global shard indices — SURVEY section 2.2
  "jax.distributed (DCN across slices)").'''
  import json
  import os
  import socket
  import subprocess
  import sys

  worker = tmp_path / 'dcn_worker.py'
  worker.write_text(_DCN_WORKER)
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  repoRoot = os.path.dirname(os.path.dirname(os.path.abspath(
      benchmarks.__file__)))
  env = dict(os.environ,
             JAX_PLATFORMS='cpu',
             XLA_FLAGS='--xla_force_host_platform_device_count=4',
             DCN_TMP=str(tmp_path))
  procs = [subprocess.Popen(
      [sys.executable, str(worker), f'localhost:{port}', str(i), repoRoot],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
      for i in range(2)]
  outs = []
  for p in procs:
    out, err = p.communicate(timeout=420)
    assert p.returncode == 0, err[-2000:]
    outs.append(json.loads(out.strip().splitlines()[-1]))
  assert outs[0] == outs[1], outs

  # single-process 8-device mesh, same key -> identical shard streams
  from optics_design_workbench.parallel import sharded
  mesh = makeMesh(nDevices=8)
  scene = benchmarks.buildLensMirrorScene(tmpdir=str(tmp_path / 'solo'))
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  histSpec = fused.makeHistogramSpec(device, info,
                                     bounds=(-60., 60., -60., 60.),
                                     bins=(32, 32))
  step = sharded.makeShardedFusedStep(mesh, device, src.deviceGenerator(),
                                      histSpec, raysPerStep=8 * 256,
                                      maxIntersections=4, maxRayLength=1e6,
                                      distTol=1e-4)
  h, c = step(jax.random.PRNGKey(0), fused.initHistograms(histSpec))
  assert int(c['segments']) == outs[0]['segments']
  assert int(c['hits']) == outs[0]['hits']
  assert float(np.asarray(h['counts']).sum()) == outs[0]['checksum']


def test_sharded_step_matches_summed_per_shard_steps():
  '''The sharded fused step (the path of WorkerProcessCount > 1) against
  its per-shard steps run one after another and summed — the comparison
  `chip_smoke.py --four` makes on four GPUs. Counts are integers, so they
  agree exactly; powers are float32 sums in another order.'''
  mesh = makeMesh(nDevices=4)
  N = 4 * 1024
  step, hist0, meta = benchmarks.makeBenchStep(
      raysPerStep=N, maxIntersections=6, bins=(32, 32), mesh=mesh)
  key = jax.random.PRNGKey(21)
  hist, counters = step(key, hist0)
  ref, refCounters = benchmarks.perShardReference(meta, key, 4, N, 6)
  assert int(counters['hits']) == refCounters['hits'] > 0.9 * N
  assert int(counters['segments']) == refCounters['segments']
  np.testing.assert_array_equal(np.asarray(hist['counts']), ref['counts'])
  np.testing.assert_allclose(np.asarray(hist['power']), ref['power'],
                             rtol=1e-5, atol=1e-6 * ref['power'].max())
