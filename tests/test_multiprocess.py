'''
OS-process worker pool tests — parity with the reference's master/worker
architecture (reference: simulation/processes/simulation_loop.py:449-707,
worker_process.py, results_store.py:462-550):

  * a continuous run with N workers writes into ONE shared run folder,
    result files keyed by worker pid, and the master stops everyone once
    the SUMMED progress counters reach the end criteria;
  * a deterministic single-shot 'fans' run splits the fan initial
    conditions statically across workers (the host analog of the
    reference's initial-conditions file queue, results_store.py:679-738)
    and the union of hits equals the single-process run.

Workers are real subprocesses running the CPU backend (forceCpu).
'''

import glob
import os
import re

import numpy as np
import pytest

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup,
                                            SimulationSettings)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation
from optics_design_workbench.parallel import runMultiprocess
from optics_design_workbench.simulation import results_store as RS


def makeScene(path, **srcProps):
  scene = Scene(label='mp', path=path)
  detector = OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.translation(0, 0, 100)])
  scene.addOpticalGroup(detector)
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', Wavelength=532.,
      ThetaResolutionNumericMode='2e4', **srcProps))
  scene.addSimulationSettings(
      EndAfterRays='1e4', RaysPerIteration=2000, MaxIntersections=5,
      MaxRayLength=1000, EnableStoreSingleShotData=True,
      StoreHitFanIndex=True, StoreHitRayIndex=True)
  return scene


def loadHitColumns(runPath):
  cols = None
  for folder in glob.glob(f'{runPath}/source-*/object-*'):
    for f in RS.resultFilePaths(folder, 'hits'):
      data = RS.loadResultFile(f)
      if cols is None:
        cols = {k: [v] for k, v in data.items() if v.ndim > 0}
      else:
        for k in cols:
          cols[k].append(data[k])
  if cols is None:
    return None
  out = {k: np.concatenate(v) for k, v in cols.items()}
  n = len(out['points'])
  return {k: v for k, v in out.items() if len(v) == n}


def writerPids(runPath):
  pids = set()
  for folder in glob.glob(f'{runPath}/source-*/object-*'):
    for f in os.listdir(folder):
      m = re.search(r'-pid(\d+)-', f)
      if m:
        pids.add(int(m.group(1)))
  return pids


@pytest.mark.long
def test_continuous_two_workers_shared_folder(tmp_path):
  scene = makeScene(str(tmp_path / 'mp'))
  runPath = runMultiprocess(scene, 'true', workerCount=2, forceCpu=True,
                            pollSeconds=.2, timeoutSeconds=600)
  assert runPath and os.path.isdir(runPath)
  # both workers flushed result files into the one shared run folder,
  # keyed by their pid (the reference folder contract)
  pids = writerPids(runPath)
  assert len(pids) >= 2, f'expected >=2 worker pids, got {pids}'
  assert os.getpid() not in pids   # lazy master traces nothing itself
  hits = loadHitColumns(runPath)
  assert hits is not None
  # summed end criterion: >=1e4 rays traced in total; nearly all land on
  # the detector, split across the two workers
  assert len(hits['points']) >= 8000
  assert np.allclose(hits['points'][:, 2], 100., atol=1e-3)
  # master wrote progress snapshots and the lifecycle flags are cleared
  from optics_design_workbench.simulation.lifecycle import Lifecycle
  lc = Lifecycle(RS.getResultsFolderPath(scene.path))
  assert not lc.isRunning(attemptCleanup=False)


@pytest.mark.long
def test_fans_split_across_workers_matches_single_process(tmp_path):
  sceneA = makeScene(str(tmp_path / 'single'), Fans=4, RaysPerFan=33)
  singleRun = simulation.runSimulation(sceneA, 'fans', store=True)
  ref = loadHitColumns(singleRun)
  assert ref is not None

  sceneB = makeScene(str(tmp_path / 'multi'), Fans=4, RaysPerFan=33)
  runPath = runMultiprocess(sceneB, 'fans', workerCount=2, forceCpu=True,
                            pollSeconds=.2, timeoutSeconds=600)
  got = loadHitColumns(runPath)
  assert got is not None
  # no duplicated work: every worker traced a disjoint strided slice, the
  # union reproduces the single-process fan hit set exactly
  assert len(got['points']) == len(ref['points'])

  def sortRows(cols):
    order = np.lexsort((cols['rayIndex'], cols['fanIndex']))
    return {k: v[order] for k, v in cols.items()}

  refS, gotS = sortRows(ref), sortRows(got)
  np.testing.assert_allclose(gotS['points'], refS['points'], atol=1e-6)
  np.testing.assert_array_equal(gotS['fanIndex'], refS['fanIndex'])
  np.testing.assert_array_equal(gotS['rayIndex'], refS['rayIndex'])
  assert len(writerPids(runPath)) >= 2


@pytest.mark.long
def test_dead_worker_is_revived(tmp_path):
  '''Babysitting: a worker killed mid-run (SIGKILL) is revived by the
  master (reference: simulation_loop.py:688-698) — after the run, hit
  files from at least 3 distinct worker pids exist (2 original + >=1
  revival incarnation).'''
  import signal
  import threading
  import time

  scene = makeScene(str(tmp_path / 'revive'))
  scene.getObject('SimulationSettings').EndAfterRays = '1e9'
  scene.getObject('SimulationSettings').RaysPerIteration = 2000
  resultsFolder = RS.getResultsFolderPath(scene.path)

  def currentWriterPids():
    pids = set()
    for run in glob.glob(os.path.join(resultsFolder, 'raw',
                                       'simulation-run-*')):
      pids |= writerPids(run)
    return pids

  def killer():
    # wait until BOTH workers have flushed result files, then SIGKILL one
    # of the writing pids
    deadline = time.time() + 90
    while time.time() < deadline:
      pids = currentWriterPids()
      if len(pids) >= 2:
        try:
          os.kill(sorted(pids)[0], signal.SIGKILL)
        except OSError:
          pass
        return
      time.sleep(.5)

  t = threading.Thread(target=killer, daemon=True)
  t.start()
  runPath = runMultiprocess(scene, 'true', workerCount=2, forceCpu=True,
                            pollSeconds=.3, timeoutSeconds=150)
  t.join(timeout=5)
  pids = writerPids(runPath)
  assert len(pids) >= 3, \
      f'expected >=3 writer pids (one revival), got {pids}'


def test_scheduled_worker_end_of_life(tmp_path):
  '''workerMaxLifetimeSeconds: a continuous run's workers are cleanly
  respawned past their lifetime (reference: 10h+2h-jitter worker
  end-of-life, worker_process.py:44-45) and the run still completes with
  hits from both incarnations.'''
  from optics_design_workbench.parallel.multiprocess import \
      runMultiprocess
  from optics_design_workbench.utils import io as uio
  logPath = uio.setLogfile(str(tmp_path / 'master.log'))
  scene = makeScene(str(tmp_path / 'eol'))
  # pace the run so the tracing work (the EOL clock starts at a worker's
  # first progress dump, not at launch: startup/jit time must not eat the
  # lifetime) spans several 5s lifetimes — ~20k rays/s/worker on the CPU
  # mesh means 3e5 rays is ~8s of tracing per worker
  scene.activeSimulationSettings().EndAfterRays = '3e5'
  scene.activeSimulationSettings().RaysPerIteration = 200
  runFolder = runMultiprocess(scene, 'true', workerCount=2, forceCpu=True,
                              timeoutSeconds=900,
                              workerMaxLifetimeSeconds=5)
  from optics_design_workbench.jupyter_utils.document import RawFolder
  raw = RawFolder(runFolder)
  prog = raw.progress()
  assert prog['totalTracedRays'] >= 3e5
  hits = raw.loadHits()
  assert len(hits) > 0
  # the scheduled respawn actually happened (logged by the master)
  assert 'scheduled end-of-life' in open(logPath).read()


@pytest.mark.long
def test_histogram_recording_two_workers_matches_single_process(tmp_path):
  '''runMultiprocess(recording='histogram', workerCount=2): each worker
  keeps its own cumulative snapshot file and loadHistogramSnapshots sums
  the latest per worker — the summed histogram must statistically match a
  single-process histogram run of the same scene (round-2 VERDICT #4: the
  old protocol silently kept only the last-flushing worker's counts).'''
  def histStats(runPath):
    snaps = RS.loadHistogramSnapshots(runPath)
    assert 'Source' in snaps and 'Detector' in snaps['Source']
    H = snaps['Source']['Detector']['counts']
    n = H.sum()
    ys, xs = np.indices(H.shape)
    cy, cx = (H * ys).sum() / n, (H * xs).sum() / n
    spread = np.sqrt((H * ((ys - cy) ** 2 + (xs - cx) ** 2)).sum() / n)
    return n, cy, cx, spread

  sceneA = makeScene(str(tmp_path / 'single'))
  singleRun = simulation.runSimulation(sceneA, 'true', store=True,
                                       recording='histogram')
  nS, cyS, cxS, spS = histStats(singleRun)
  assert nS >= 8000            # most of the 1e4 rays land on the detector

  sceneB = makeScene(str(tmp_path / 'multi'))
  runPath = runMultiprocess(sceneB, 'true', workerCount=2, forceCpu=True,
                            pollSeconds=.2, timeoutSeconds=600,
                            recording='histogram')
  # two distinct worker snapshot files survived (per-worker keying)
  snapFiles = glob.glob(f'{runPath}/source-*/*-histograms.npz')
  workerKeys = {re.search(r'(pid\d+-thread\d+)', os.path.basename(f))
                .group(1) for f in snapFiles}
  assert len(workerKeys) >= 2, \
      f'expected snapshots from >=2 workers, got {workerKeys}'
  nM, cyM, cxM, spM = histStats(runPath)
  # both workers' counts are in the sum: the multi run stops once the
  # SUMMED rays reach 1e4, so its hit total must be comparable to (not
  # half of) the single-process run — well above one worker's share
  assert nM >= 0.7 * nS
  # same physical distribution: centroid and spread agree within MC error
  assert abs(cyM - cyS) < 2. and abs(cxM - cxS) < 2.
  assert abs(spM - spS) < 0.1 * spS


def test_worker_environments_one_card_each():
  from optics_design_workbench.parallel.multiprocess import \
      workerEnvironments
  envs = workerEnvironments(3, False, dict(FOO='1'),
                            gpuIds=['0', '1', '2', '3'])
  assert [e['CUDA_VISIBLE_DEVICES'] for e in envs] == ['0', '1', '2']
  assert all(e['FOO'] == '1' and 'JAX_PLATFORMS' not in e for e in envs)
  # ids come from the parent's own CUDA_VISIBLE_DEVICES list
  envs = workerEnvironments(2, False, {}, gpuIds=['5', '7'])
  assert [e['CUDA_VISIBLE_DEVICES'] for e in envs] == ['5', '7']


def test_more_workers_than_cards_refused(tmp_path):
  from optics_design_workbench.parallel.multiprocess import \
      workerEnvironments
  with pytest.raises(ValueError, match='cannot share a card'):
    workerEnvironments(3, False, {}, gpuIds=['0', '1'])
  # forceCpu keeps every worker on the CPU, however many there are
  envs = workerEnvironments(3, True, {}, gpuIds=['0', '1'])
  assert all(e['JAX_PLATFORMS'] == 'cpu'
             and 'CUDA_VISIBLE_DEVICES' not in e for e in envs)


def test_refusal_happens_before_any_worker_starts(tmp_path, monkeypatch):
  from optics_design_workbench.parallel import multiprocess as MP
  monkeypatch.setattr(MP, 'visibleGpuIds', lambda: ['0'])
  scene = makeScene(str(tmp_path / 'refuse'))
  with pytest.raises(ValueError, match='1 GPU'):
    runMultiprocess(scene, 'true', workerCount=2)
  assert not glob.glob(str(tmp_path / 'refuse.OpticsDesign' / 'raw' / '*'))


@pytest.mark.parametrize('env,expected', [
    (dict(JAX_PLATFORMS='cpu', CUDA_VISIBLE_DEVICES='0,1'), []),
    (dict(JAX_PLATFORMS='cuda,cpu', CUDA_VISIBLE_DEVICES='2,3'),
     ['2', '3']),
    (dict(JAX_PLATFORMS='cuda', CUDA_VISIBLE_DEVICES='-1'), []),
])
def test_visible_gpu_ids(monkeypatch, env, expected):
  from optics_design_workbench.parallel.multiprocess import visibleGpuIds
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  assert visibleGpuIds() == expected
