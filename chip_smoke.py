#!/usr/bin/env python
'''
Smoke run of the main path on one NVIDIA GPU, in ONE process (a JAX process
reserves most of a card's memory, so only one may open it):

  0. environment: card name and power limit, jax devices, sympy, g++ and
     the native spool build; fails unless jax's first device is a GPU;
  1. compile the fused step of the bench cell (lens + fold mirror +
     detector, 4,194,304 rays, 6 bounces, 128x128 bins): compile seconds,
     memory analysis, peak device bytes after one step;
  2. the same fused step at 1,048,576 rays on the GPU and on the CPU of
     this process, same key: total hits, total power and the count
     histograms must agree;
  3. the batch tracer against the per-ray oracle (tracing.traceReference)
     on the GPU, 65,536 rays of the mixed-interaction scene;
  4. the four user entry points at their real sizes: a histogram run and a
     surface-source run (runSimulation), a stored raw-hit run read back
     through Document, and the examples/3 batched lens-radius sweep
     (ParameterSweeper.evaluateBatched).

Every phase prints one line; every rate carries the card's name and power
limit. Any failure raises, so the process exits non-zero and never prints
the last line, which is exactly
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs: the sharded runSimulation
                                    # path and its per-shard comparison only
    python chip_smoke.py --cpu-rehearsal [--four]
                                    # the same phases on the CPU at 1/1024
                                    # of the sizes (8 virtual devices);
                                    # checks control flow, prints no ok line
'''

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time


def cardLine():
  out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60, check=True).stdout
  return out.strip().splitlines()[0]


def parseArgs():
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--four', action='store_true',
                  help='run only the four-GPU sharded path')
  ap.add_argument('--cpu-rehearsal', action='store_true',
                  help='run on the CPU at 1/1024 of the sizes')
  return ap.parse_args()


ARGS = parseArgs()
if ARGS.cpu_rehearsal:
  os.environ['JAX_PLATFORMS'] = 'cpu'
  os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                             ' --xla_force_host_platform_device_count=8')

import numpy as np
import jax
import jax.numpy as jnp

SHIFT = 10 if ARGS.cpu_rehearsal else 0
BENCH_RAYS = (1 << 22) >> SHIFT
AGREE_RAYS = (1 << 20) >> SHIFT
ORACLE_RAYS = (1 << 16) >> SHIFT
RAW_RAYS = (1 << 20) >> SHIFT
SWEEP_RAYS = 200_000 >> SHIFT
HIST_END_RAYS = 2.5e8 / (1 << SHIFT)
RAW_END_RAYS = 1e7 / (1 << SHIFT)
BINS = (128, 128)


def line(phase, **fields):
  body = ', '.join(f'{k}={v}' for k, v in fields.items())
  print(f'[{phase}] {body}', flush=True)


def check(cond, what):
  if not cond:
    raise AssertionError(what)


# ------------------------------------------------------------------ phase 0

def phaseEnvironment():
  import optics_design_workbench    # fails outside a checkout of the repo
  devices = jax.devices()
  if not ARGS.cpu_rehearsal and devices[0].platform != 'gpu':
    raise SystemExit(f'no GPU: jax reports {devices} '
                     f'(chip_smoke needs an NVIDIA GPU)')
  card = 'cpu rehearsal' if ARGS.cpu_rehearsal else cardLine()
  print(card, flush=True)
  import sympy
  gpp = shutil.which('g++')
  check(gpp is not None, 'g++ not found (the native spool needs it)')
  from optics_design_workbench.utils import native_store
  nativeOk = native_store.loadNativeLib() is not None
  check(nativeOk, 'native spool build failed')
  line('phase 0 environment', card=card, devices=devices,
       jax=jax.__version__, sympy=sympy.__version__, gxx=gpp,
       native_spool='built')
  return card, devices


# ------------------------------------------------------------------ phase 1

def phaseCompile(card, dev):
  from optics_design_workbench import benchmarks
  scene = benchmarks.buildLensMirrorScene()
  step, hist, meta = benchmarks.makeBenchStep(
      scene, raysPerStep=BENCH_RAYS, maxIntersections=6, bins=BINS)
  key = jax.random.PRNGKey(0)
  t0 = time.perf_counter()
  compiled = step.lower(key, hist).compile()
  compileSeconds = time.perf_counter() - t0
  mem = compiled.memory_analysis()
  t0 = time.perf_counter()
  hist, counters = compiled(key, hist)
  jax.block_until_ready((hist, counters))
  stepSeconds = time.perf_counter() - t0
  stats = dev.memory_stats() or {}
  peak = stats.get('peak_bytes_in_use')
  nSurf = int(np.asarray(meta['device']['surfaces']['kind']).shape[0])
  segs = int(counters['segments'])
  temp = getattr(mem, 'temp_size_in_bytes', None)
  line('phase 1 compile', rays=BENCH_RAYS, compile_s=f'{compileSeconds:.2f}',
       first_step_s=f'{stepSeconds:.4f}', temp_bytes=temp,
       argument_bytes=getattr(mem, 'argument_size_in_bytes', None),
       output_bytes=getattr(mem, 'output_size_in_bytes', None),
       peak_bytes_in_use=peak, surfaces=nSurf,
       temp_bytes_per_surface_ray=(f'{temp / (nSurf * BENCH_RAYS):.1f}'
                                   if temp else None),
       segments_per_ray=f'{segs / BENCH_RAYS:.4f}', card=card)
  check(segs >= BENCH_RAYS, 'fewer segments than rays')
  check(ARGS.cpu_rehearsal or (peak or 0) > 0, 'no device memory in use')
  return segs / BENCH_RAYS


# ------------------------------------------------------------------ phase 2

def phaseAgreeWithCpu(card):
  '''One fused step, same key, on the GPU and on this process's CPU.
  Limits: transcendental functions differ in the last ulp between the two
  backends, which moves hit points by ~1e-5 mm, so only rays that close to
  a bin edge or an aperture rim can change bin or fate.'''
  from optics_design_workbench import benchmarks

  def run(device):
    with jax.default_device(device):
      step, hist, _ = benchmarks.makeBenchStep(
          raysPerStep=AGREE_RAYS, maxIntersections=6, bins=BINS)
      hist, counters = step(jax.random.PRNGKey(7), hist)
      return (np.asarray(hist['counts'], np.float64),
              np.asarray(hist['power'], np.float64),
              int(counters['hits']))

  cG, pG, hG = run(jax.devices()[0])
  cC, pC, hC = run(jax.devices('cpu')[0])
  hitsRel = abs(hG - hC) / max(hC, 1)
  powerRel = abs(pG.sum() - pC.sum()) / max(pC.sum(), 1e-30)
  l1 = np.abs(cG - cC).sum() / max(cC.sum(), 1.)
  line('phase 2 gpu-vs-cpu', rays=AGREE_RAYS, hits_gpu=hG, hits_cpu=hC,
       hits_rel=f'{hitsRel:.3e} (limit 1e-4)',
       power_rel=f'{powerRel:.3e} (limit 1e-4)',
       counts_l1=f'{l1:.3e} (limit 1e-3)', card=card)
  check(hG > 0.5 * AGREE_RAYS, 'too few hits on the GPU')
  check(hitsRel <= 1e-4, 'total hits differ between GPU and CPU')
  check(powerRel <= 1e-4, 'total detector power differs between GPU and CPU')
  check(l1 <= 1e-3, 'count histograms differ between GPU and CPU')


# ------------------------------------------------------------------ phase 3

def phaseOracle(card):
  from optics_design_workbench import benchmarks, tracing
  scene = benchmarks.buildMixedInteractionScene()
  n = ORACLE_RAYS
  o, d = benchmarks.mixedInteractionRays(jax.random.PRNGKey(3), n)
  args = (scene, o, d, jnp.ones((n,)), jnp.full((n,), 550.))
  kw = dict(maxIntersections=6, maxRayLength=1000., distTol=1e-4)
  ref = tracing.traceReference(*args, **kw)
  _state, rec = tracing.trace(*args, recordSegments=False, **kw)
  agree = benchmarks.oracleAgreement(ref, rec)
  line('phase 3 per-ray oracle', rays=n,
       same_element=f'{agree["sameElementFraction"]:.6f} (limit >= 0.9999)',
       max_point_mm=f'{agree["maxPointDistance"]:.3e} (limit 1e-3)',
       max_power_rel=f'{agree["maxPowerRelDiff"]:.3e} (limit 1e-5)',
       card=card)
  check(agree['sameElementFraction'] >= 0.9999, 'hit elements differ')
  check(agree['maxPointDistance'] <= 1e-3, 'hit points differ')
  check(agree['maxPowerRelDiff'] <= 1e-5, 'hit powers differ')


# ------------------------------------------------------------------ phase 4

def _configure(scene, **settings):
  s = scene.activeSimulationSettings()
  for k, v in settings.items():
    setattr(s, k, v)
  return scene


def _timedRun(scene, **kw):
  from optics_design_workbench import simulation
  from optics_design_workbench.jupyter_utils import RawFolder
  marks = []

  def onProgress(p):
    marks.append((time.perf_counter(), p['totalTracedRays']))
  t0 = time.perf_counter()
  runPath = simulation.runSimulation(scene, 'true', seed=5,
                                     progressCallback=onProgress, **kw)
  wall = time.perf_counter() - t0
  raw = RawFolder(runPath)
  rays = int(raw.progress()['totalTracedRays'])
  # steady rate: from the end of the first loop pass (which compiles) on
  (tA, rA), (tB, rB) = marks[0], marks[-1]
  steady = (rB - rA) / (tB - tA) if tB > tA else float('nan')
  return raw, rays, wall, steady


def phaseHistogramRun(card, label, scene, segmentsPerRay, tmp):
  from optics_design_workbench.simulation import results_store
  _configure(scene, RaysPerIteration=BENCH_RAYS, MaxIntersections=6,
             EndAfterRays=HIST_END_RAYS)
  raw, rays, wall, steady = _timedRun(scene, recording='histogram',
                                      histBins=BINS,
                                      histBounds=(-60., 60., -60., 60.))
  hists = results_store.loadHistogramSnapshots(raw.path)
  counts = sum(float(np.asarray(h['counts']).sum())
               for src in hists.values() for h in src.values())
  check(rays >= HIST_END_RAYS, f'{label}: run ended early ({rays} rays)')
  check(counts > 0, f'{label}: empty detector histograms')
  line(f'phase 4 {label}', rays=rays, wall_s=f'{wall:.2f}',
       rays_per_s_end_to_end=f'{rays / wall:.4e}',
       rays_per_s_steady=f'{steady:.4e}',
       segments_per_s_steady=f'{steady * segmentsPerRay:.4e}',
       hit_fraction=f'{counts / rays:.6f}',
       device_idle_share='not measured', card=card)
  return counts / rays


def phaseRawRun(card, histHitFraction, segmentsPerRay, tmp):
  from optics_design_workbench import benchmarks
  from optics_design_workbench.jupyter_utils import Document
  scene = benchmarks.buildLensMirrorScene(tmpdir=tmp)
  _configure(scene, RaysPerIteration=RAW_RAYS, MaxIntersections=6,
             EndAfterRays=RAW_END_RAYS)
  raw, rays, wall, steady = _timedRun(scene, recording='raw')
  hits = Document(scene=scene).latestRawFolder().loadHits('Detector')
  frac = len(hits) / rays
  # binomial standard error of the difference of the two hit fractions
  sigma = math.sqrt(frac * (1 - frac) / rays
                    + histHitFraction * (1 - histHitFraction)
                    / HIST_END_RAYS)
  line('phase 4 raw run', rays=rays, stored_hits=len(hits),
       wall_s=f'{wall:.2f}', rays_per_s_end_to_end=f'{rays / wall:.4e}',
       rays_per_s_steady=f'{steady:.4e}',
       segments_per_s_steady=f'{steady * segmentsPerRay:.4e}',
       hit_fraction=f'{frac:.6f} (histogram run {histHitFraction:.6f}, '
                    f'limit |diff| <= 5 sigma = {5 * sigma:.2e})',
       device_idle_share='not measured', card=card)
  check(len(hits) > 0, 'raw run stored no hits')
  check(np.isfinite(hits.points()).all(), 'non-finite stored hit points')
  check(abs(frac - histHitFraction) <= 5 * sigma,
        'raw-run hit fraction disagrees with the histogram run')


def _loadExample3():
  import importlib.util
  here = os.path.dirname(os.path.abspath(__file__))
  spec = importlib.util.spec_from_file_location(
      'example3', os.path.join(here, 'examples', '3_parameter_sweeps.py'))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _spotStats(power, counts):
  '''[hits, mean x bin, mean y bin, var x, var y] of detector 0.'''
  H = counts[0]
  n = max(H.sum(), 1.)
  ys, xs = np.indices(H.shape)
  cx, cy = (H * xs).sum() / n, (H * ys).sum() / n
  return np.array([H.sum(), cx, cy, (H * (xs - cx) ** 2).sum() / n,
                   (H * (ys - cy) ** 2).sum() / n])


def phaseSweep(card, tmp):
  from optics_design_workbench.jupyter_utils import (ParameterSweeper,
                                                     Parameter)
  ex3 = _loadExample3()
  holder = dict(scene=ex3.buildScene(path=os.path.join(tmp, 'ex3')), R=60.)

  def setRadius(r):
    holder['R'] = float(r)
    holder['scene'] = ex3.buildScene(float(r),
                                     path=os.path.join(tmp, 'ex3'))
    sweeper.scene = holder['scene']

  sweeper = ParameterSweeper(
      lambda sc: dict(R=Parameter(getter=lambda: holder['R'],
                                  setter=setRadius, bounds=(40., 100.))),
      scene=holder['scene'])
  radii = np.linspace(45., 95., 11)
  kw = dict(sceneFactory=lambda: holder['scene'], raysPerScene=SWEEP_RAYS,
            maxIntersections=6, bins=(64, 64),
            histBounds=(-40., 40., -40., 40.))
  t0 = time.perf_counter()
  sweeper.evaluateBatched([dict(R=r) for r in radii], _spotStats, seed=1,
                          **kw)
  cold = time.perf_counter() - t0
  t0 = time.perf_counter()
  stats = sweeper.evaluateBatched([dict(R=r) for r in radii], _spotStats,
                                  seed=2, **kw)
  warm = time.perf_counter() - t0
  alone = sweeper.evaluateBatched([dict(R=radii[0])], _spotStats, seed=3,
                                  **kw)[0]
  v0 = stats[0]
  n = SWEEP_RAYS
  p = v0[0] / n
  hitsSigma = max(math.sqrt(2 * p * (1 - p) / n) * n, 1.)
  cSigma = [math.sqrt(v0[3] / v0[0] + alone[3] / alone[0]),
            math.sqrt(v0[4] / v0[0] + alone[4] / alone[0])]
  dx, dy = abs(v0[1] - alone[1]), abs(v0[2] - alone[2])
  rays = len(radii) * n
  line('phase 4 batched sweep', variants=len(radii), rays_per_variant=n,
       cold_s=f'{cold:.2f}', warm_s=f'{warm:.3f}',
       rays_per_s_warm=f'{rays / warm:.4e}',
       segments_per_s='not counted by evaluateBatched',
       variant0_hits=f'{v0[0]:.0f} vs alone {alone[0]:.0f} '
                     f'(limit 5 sigma = {5 * hitsSigma:.0f})',
       variant0_centroid_shift_bins=f'{dx:.3f},{dy:.3f} (limit '
                                    f'{5 * cSigma[0]:.3f},'
                                    f'{5 * cSigma[1]:.3f})',
       device_idle_share='not measured', card=card)
  check(np.isfinite(stats).all() and stats.shape == (len(radii), 5),
        'sweep statistics malformed')
  check(v0[0] > 0, 'sweep variant 0 recorded no hits')
  check(abs(v0[0] - alone[0]) <= 5 * hitsSigma,
        'sweep variant 0 hit count disagrees with the variant alone')
  check(dx <= 5 * cSigma[0] and dy <= 5 * cSigma[1],
        'sweep variant 0 spot centroid disagrees with the variant alone')


# ------------------------------------------------------------- four cards

def phaseFour(card):
  '''WorkerProcessCount=4 shards every ray batch over four devices
  (parallel.makeShardedFusedStep, histograms summed by psum). Compared
  with the four per-shard steps run one after another on device 0 with
  the same folded keys and then summed. Counts are integers below 2^24,
  so they must agree exactly; powers are float32 sums taken in another
  order (psum and atomics), so each bin may move by rounding: relative
  limit 1e-5 of the bin's own value plus 1e-6 of the largest bin.'''
  from optics_design_workbench import benchmarks
  from optics_design_workbench.parallel import makeMesh
  devices = jax.devices()
  check(len(devices) >= 4, f'--four needs 4 devices, jax sees {devices}')
  rays = 4 * BENCH_RAYS

  with tempfile.TemporaryDirectory() as tmp:
    scene = _configure(benchmarks.buildLensMirrorScene(tmpdir=tmp),
                       RaysPerIteration=rays, MaxIntersections=6,
                       EndAfterRays=40 * rays, WorkerProcessCount=4)
    raw, traced, wall, steady = _timedRun(scene, recording='histogram',
                                          histBins=BINS,
                                          histBounds=(-60., 60., -60., 60.))
  check(traced >= 40 * rays, 'sharded run ended early')
  line('four runSimulation', devices=4, rays_per_iteration=rays,
       rays=traced, wall_s=f'{wall:.2f}',
       rays_per_s_steady=f'{steady:.4e}', card=card)

  mesh = makeMesh(nDevices=4)
  step, hist0, meta = benchmarks.makeBenchStep(
      raysPerStep=rays, maxIntersections=6, bins=BINS, mesh=mesh)
  key = jax.random.PRNGKey(21)
  hist, counters = step(key, hist0)
  jax.block_until_ready(hist)
  peaks = [(d.memory_stats() or {}).get('peak_bytes_in_use', 0)
           for d in devices[:4]]

  ref, refCounters = benchmarks.perShardReference(meta, key, 4, rays, 6)
  refCounts, refPower = ref['counts'], ref['power']
  refHits, refSegs = refCounters['hits'], refCounters['segments']
  counts = np.asarray(hist['counts'], np.float64)
  power = np.asarray(hist['power'], np.float64)
  powerErr = np.abs(power - refPower)
  powerLimit = 1e-5 * np.abs(refPower) + 1e-6 * np.abs(refPower).max()
  line('four sharded-vs-per-shard', rays=rays,
       hits=f'{int(counters["hits"])} vs {refHits}',
       segments=f'{int(counters["segments"])} vs {refSegs}',
       counts_equal=bool(np.array_equal(counts, refCounts)),
       max_power_err_over_limit=f'{(powerErr / powerLimit).max():.3f} '
                                f'(limit 1)',
       peak_bytes_in_use=peaks, card=card)
  check(int(counters['hits']) == refHits, 'sharded hits differ')
  check(int(counters['segments']) == refSegs, 'sharded segments differ')
  check(np.array_equal(counts, refCounts), 'sharded counts differ')
  check((powerErr <= powerLimit).all(), 'sharded powers differ')
  check(ARGS.cpu_rehearsal or all(p > 0 for p in peaks),
        'a device did no work')


def main():
  card, devices = phaseEnvironment()
  dev = devices[0]
  if ARGS.four:
    phaseFour(card)
  else:
    from optics_design_workbench import benchmarks
    segmentsPerRay = phaseCompile(card, dev)
    phaseAgreeWithCpu(card)
    phaseOracle(card)
    with tempfile.TemporaryDirectory() as tmp:
      histFrac = phaseHistogramRun(
          card, 'histogram run',
          benchmarks.buildLensMirrorScene(tmpdir=tmp), segmentsPerRay, tmp)
      ssScene = benchmarks.buildSurfaceSourceScene(tmpdir=tmp)
      ssStep, ssHist, _ = benchmarks.makeBenchStep(
          ssScene, raysPerStep=BENCH_RAYS, maxIntersections=6, bins=BINS)
      _, ssCounters = ssStep(jax.random.PRNGKey(1), ssHist)
      phaseHistogramRun(card, 'surface-source run', ssScene,
                        int(ssCounters['segments']) / BENCH_RAYS, tmp)
      phaseRawRun(card, histFrac, segmentsPerRay, tmp)
      phaseSweep(card, tmp)
  print(card, flush=True)
  if ARGS.cpu_rehearsal:
    print(json.dumps(dict(rehearsal=True, platform=dev.platform)))
    return
  print(json.dumps(dict(ok=True, device=dict(
      platform=dev.platform, kind=dev.device_kind,
      count=len(jax.devices())))))


if __name__ == '__main__':
  main()
