#!/usr/bin/env python
'''
Scene-class throughput of the fused device step, one stage per scene class:

    python tools/scene_throughput.py [--only a,b] [--json out.json]

Every stage builds its step through benchmarks.makeBenchStep — the same
fused sample+trace+histogram step runSimulation builds in histogram mode —
and reports compile seconds and ray-segments per second over timed windows
that end in block_until_ready, with the device it ran on. A failing stage
raises: the script stops and exits non-zero. The scene builders are the
candidate cells of the benchmark (see ROADMAP.md).

  headline           lens + fold mirror + detector (benchmarks bench cell)
  surface_source     cos^2(theta) disc emitter past a fold mirror
  diffuse_scatter    theta-only lobe diffuser
  conditioned_dirac  theta_in-conditioned lobe + DiracDelta event
  coupled_scatter    theta|phi-coupled (astigmatic) lobe
  mesh_fold          two-triangle fold mirror
  spectrometer       reflection grating
  mesh_dish          200-triangle dish, wide source
  mesh_dish_coherent same dish, narrow off-axis beam
  mesh_dish_1800     1,800-triangle dish
  mesh_dish_5k       5,000-triangle dish
  mesh_dish_12k      12,800-triangle dish
  torus_mirror       toroidal fold mirror
  surf_wall          522-surface mirror wall
  surf_5k            5,070-surface mirror wall
  sweep_batched      examples/3 batched lens-radius sweep (evaluateBatched)
'''

import argparse
import json
import os
import subprocess
import sys
import time

# Self-sufficient import path: the scene builders import the package lazily,
# so running `python tools/scene_throughput.py` from any cwd must work.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax


def measureHistScene(scene, maxIntersections, bounds, bins=(128, 128),
                     raysPerStep=1 << 22, windows=3, stepsPerWindow=8):
  '''Compile seconds and best-window ray-segments/s of the fused step.'''
  from optics_design_workbench import benchmarks
  step, hist, _ = benchmarks.makeBenchStep(
      scene, raysPerStep=raysPerStep, maxIntersections=maxIntersections,
      bins=bins, bounds=bounds)
  key = jax.random.PRNGKey(11)
  t0 = time.perf_counter()
  hist, c = step(key, hist)
  jax.block_until_ready((hist, c))
  compileS = time.perf_counter() - t0
  best = 0.
  for w in range(windows):
    segs = []
    t0 = time.perf_counter()
    for i in range(stepsPerWindow):
      hist, c = step(jax.random.fold_in(key, 1000 * w + i), hist)
      segs.append(c['segments'])
    jax.block_until_ready((hist, segs))
    dt = time.perf_counter() - t0
    best = max(best, sum(int(x) for x in segs) / dt)
  return best, dict(compileS=round(compileS, 2), raysPerStep=raysPerStep,
                    stepsPerWindow=stepsPerWindow)


def sceneHeadline():
  from optics_design_workbench import benchmarks
  return (benchmarks.buildLensMirrorScene(), 6, (-60., 60., -60., 60.))


def sceneSurfaceSource():
  from optics_design_workbench import benchmarks
  return (benchmarks.buildSurfaceSourceScene(), 4,
          (-120., 120., -120., 120.))


def _scatterScene(density, thetaDom, srcTheta):
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label='scat_tp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Diffuser', Reflectivity=1.0,
      ReflectedProbabilityDensity=density,
      PowerThetaDomain=thetaDom, PowerPhiDomain='0, 2*pi',
      surfaces=[S.plane(np.eye(4), elem=0, radius=50., orient=-1)],
      placements=[T.translation(0, 0, 50)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(500., 500.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(Label='Src',
                              PowerDensity='exp(-theta^2/0.01)',
                              ThetaDomain=srcTheta,
                              ThetaResolutionNumericMode='2e3',
                              placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene


def sceneDiffuseScatter():
  return (_scatterScene('exp(-theta^2/0.02)', '0, pi/3', '0, 0.05'), 4,
          (-100., 100., -100., 100.))


def sceneConditionedDirac():
  return (_scatterScene('DiracDelta(theta-theta_refl)'
                        ' + 5*exp(-(theta-theta_in)**2/0.02)',
                        '0, pi/2', '0, 0.3'), 4,
          (-100., 100., -100., 100.))


def sceneMeshFold():
  import math
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  c, s = math.cos(math.radians(45.)), math.sin(math.radians(45.))

  def pt(x, y):
    return (x, y * c, 60. + y * s)

  scene = Scene(label='mesh_tp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='FoldTri',
      surfaces=[S.triangle(pt(-25, -25), pt(25, -25), pt(25, 25), elem=0),
                S.triangle(pt(-25, -25), pt(25, 25), pt(-25, 25), elem=0)],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.sphere(np.eye(4), elem=0, radius=300., orient=-1)],
      placements=[np.eye(4)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.05)',
      ThetaDomain='0, 0.3', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, 3, (-300., 300., -300., 300.)


def sceneMeshDish():
  '''200-triangle dish mirror under a wide Monte-Carlo source.'''
  import math
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label='dish_tp')
  tris = []
  nQ, R0, z0 = 10, 40., 60.

  def pt(ir, ip):
    r = R0 * ir / nQ
    ph = 2 * math.pi * ip / nQ
    return (r * math.cos(ph), r * math.sin(ph), z0 + 0.004 * r * r)

  for ir in range(nQ):
    for ip in range(nQ):
      a, b = pt(ir, ip), pt(ir + 1, ip)
      c, d = pt(ir + 1, ip + 1), pt(ir, ip + 1)
      tris.append(S.triangle(a, b, c, elem=0))
      tris.append(S.triangle(a, c, d, elem=0))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Dish', surfaces=tris,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.1)', ThetaDomain='0, 0.5',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, 3, (-200., 200., -200., 200.)


def sceneMeshDishCollimated():
  '''Same 200-triangle dish, but lit by a NARROW beam (theta <= 0.03 rad)
  aimed off-center: coherent rays, as in fan/render-mode and
  collimated-source workloads (the case a broad phase would exploit).'''
  import math
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label='dishcoh_tp')
  tris = []
  nQ, R0, z0 = 10, 40., 60.

  def pt(ir, ip):
    r = R0 * ir / nQ
    ph = 2 * math.pi * ip / nQ
    return (r * math.cos(ph), r * math.sin(ph), z0 + 0.004 * r * r)

  for ir in range(nQ):
    for ip in range(nQ):
      a, b = pt(ir, ip), pt(ir + 1, ip)
      c, d = pt(ir + 1, ip + 1), pt(ir, ip + 1)
      tris.append(S.triangle(a, b, c, elem=0))
      tris.append(S.triangle(a, c, d, elem=0))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Dish', surfaces=tris,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  # beam aimed at the dish rim: tilt the source frame ~24 deg off-axis
  aim = T.rotation((0., 1., 0.), 24.) @ T.translation(0, 0, 1e-3)
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/2e-4)', ThetaDomain='0, 0.03',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=aim))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, 3, (-200., 200., -200., 200.)


def sceneTorusMirror():
  '''Toroidal fold mirror: the quartic (Ferrari + Newton) TORUS kind.'''
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label='torus_tp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Ring',
      surfaces=[S.torus(np.eye(4), elem=0, majorRadius=30.,
                        minorRadius=8.)],
      placements=[T.translation(0, 0, 80.)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-(theta-0.38)^2/0.01)',
      ThetaDomain='0.15, 0.55', Wavelength=532.,
      ThetaResolutionNumericMode='1e3'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, 3, (-200., 200., -200., 200.)


def _dishScene(nQ, thetaDom='0, 0.5', dens='exp(-theta^2/0.1)'):
  '''nQ*nQ*2-triangle paraboloid dish mirror + floor detector (the big-
  mesh scene family; nQ=10 is the mesh_dish scene).'''
  import math
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label=f'dish{nQ}_tp')
  tris = []
  R0, z0 = 40., 60.

  def pt(ir, ip):
    r = R0 * ir / nQ
    ph = 2 * math.pi * ip / nQ
    return (r * math.cos(ph), r * math.sin(ph), z0 + 0.004 * r * r)

  for ir in range(nQ):
    for ip in range(nQ):
      a, b = pt(ir, ip), pt(ir + 1, ip)
      c, d = pt(ir + 1, ip + 1), pt(ir, ip + 1)
      tris.append(S.triangle(a, b, c, elem=0))
      tris.append(S.triangle(a, c, d, elem=0))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Dish', surfaces=tris,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity=dens, ThetaDomain=thetaDom,
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene


def sceneMeshDish5k():
  '''5000-triangle CAD-scale dish under a WIDE Monte-Carlo source.'''
  return _dishScene(50), 3, (-200., 200., -200., 200.)


def sceneMeshDish1800():
  '''1800-triangle dish under the same wide Monte-Carlo source.'''
  return _dishScene(30), 3, (-200., 200., -200., 200.)


def sceneSurfWall():
  '''522 analytic surfaces (20x26 tilted mirror discs + a spherical cap +
  detector): the many-surface class.'''
  import math
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label='surfwall_tp')
  mirrors = []
  nx, ny, pitch = 26, 20, 8.
  for iy in range(ny):
    for ix in range(nx):
      cx = (ix - (nx - 1) / 2.) * pitch
      cy = (iy - (ny - 1) / 2.) * pitch
      tilt = T.compose(
          T.translation(cx, cy, 80. + 2. * math.sin(ix * 0.7 + iy)),
          T.rotation((1, 0, 0), 3. * math.cos(ix + iy * 0.5)),
          T.rotation((0, 1, 0), 3. * math.sin(ix * 0.3)))
      mirrors.append(S.plane(tilt, elem=0, radius=0.7 * pitch, orient=-1))
  mirrors.append(S.sphere(T.translation(0, 0, 140.), elem=0, radius=60.,
                          zRange=(-60., -40.), orient=+1))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Wall', surfaces=mirrors,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(300., 300.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.3)', ThetaDomain='0, 0.9',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, 3, (-300., 300., -300., 300.)


def sceneCoupledScatter():
  '''theta|phi-coupled astigmatic diffuser (reference test/70
  2-test-astigmatic-beams analog), drawn through the low-rank separable
  expansion.'''
  return (_scatterScene(
      'exp(-(theta*cos(phi))**2/0.003 - (theta*sin(phi))**2/0.05)',
      '0, pi/3', '0, 0.05'), 4, (-100., 100., -100., 100.))


def sceneMeshDish12k():
  '''12800-triangle dish: the ray-chunked (memory-guarded) class.'''
  return _dishScene(80), 3, (-200., 200., -200., 200.)


def sceneSurf5k():
  '''5070 analytic surfaces: the ray-chunked many-surface class.'''
  import math
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label='surf5k_tp')
  mirrors = []
  nx, ny, pitch = 78, 65, 3.
  for iy in range(ny):
    for ix in range(nx):
      cx = (ix - (nx - 1) / 2.) * pitch
      cy = (iy - (ny - 1) / 2.) * pitch
      tilt = T.compose(
          T.translation(cx, cy, 80. + 2. * math.sin(ix * 0.7 + iy)),
          T.rotation((1, 0, 0), 3. * math.cos(ix + iy * 0.5)))
      mirrors.append(S.plane(tilt, elem=0, radius=0.6 * pitch, orient=-1))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Wall', surfaces=mirrors,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(300., 300.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.3)', ThetaDomain='0, 0.9',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, 3, (-300., 300., -300., 300.)


def sceneSpectrometer():
  '''examples/4: reflection-grating spectrometer.'''
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S
  from optics_design_workbench.geometry import transforms as T
  scene = Scene(label='spectro_tp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Grating', Label='Grating', GratingType='Reflection',
      GratingLinesPerMillimeter=500., GratingDiffractionOrder=1,
      GratingLinesOrientation=(1., 0., 0.),
      surfaces=[S.plane(np.eye(4), elem=0, radius=40., orient=-1)],
      placements=[T.translation(0, 0, 100.)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/1e-4)', Wavelength=532.,
      ThetaDomain='0, 0.05', ThetaResolutionNumericMode='2e3'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, 3, (-80., 80., -80., 80.)


def measureSweepBatched(nVariants=11, raysPerScene=200_000):
  '''examples/3-parameter-sweeps: the batched lens-radius sweep through
  ParameterSweeper.evaluateBatched. Reports the cold wall (compile
  included) and the steady-state aggregate sampling+trace+histogram rate
  across all variants.'''
  import importlib.util
  spec = importlib.util.spec_from_file_location(
      'example3', os.path.join(os.path.dirname(os.path.dirname(
          os.path.abspath(__file__))), 'examples', '3_parameter_sweeps.py'))
  ex3 = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(ex3)
  from optics_design_workbench.jupyter_utils import (ParameterSweeper,
                                                     Parameter)

  holder = dict(scene=ex3.buildScene(), R=60.)

  def setRadius(r):
    holder['R'] = float(r)
    holder['scene'] = ex3.buildScene(float(r))
    sweeper.scene = holder['scene']

  sweeper = ParameterSweeper(
      lambda sc: dict(R=Parameter(getter=lambda: holder['R'],
                                  setter=setRadius, bounds=(40., 100.))),
      scene=holder['scene'])
  radii = np.linspace(45., 95., nVariants)

  def spotMetric(power, counts):
    H = counts[0]
    n = H.sum()
    if n == 0:
      return 1e9
    ys, xs = np.indices(H.shape)
    cy, cx = (H * ys).sum() / n, (H * xs).sum() / n
    return float((H * ((ys - cy) ** 2 + (xs - cx) ** 2)).sum() / n)

  def call(seed):
    # shift the radii per call: a real optimize() loop proposes NEW values
    # each probe, so the steady-state number must include the per-call
    # host recompiles + transfers (no value-level caching can hide them)
    return sweeper.evaluateBatched(
        [dict(R=r + 0.3 * seed) for r in radii], spotMetric,
        sceneFactory=lambda: holder['scene'],
        raysPerScene=raysPerScene, maxIntersections=6, bins=(64, 64),
        histBounds=(-40., 40., -40., 40.), seed=seed)

  t0 = time.perf_counter()
  metrics = call(0)
  coldS = time.perf_counter() - t0
  best = float(radii[int(np.argmin(metrics))])

  steady = float('inf')
  for seed in (1, 2):
    t1 = time.perf_counter()
    call(seed)
    steady = min(steady, time.perf_counter() - t1)
  rate = nVariants * raysPerScene / steady
  return rate, dict(coldS=round(coldS, 1), steadyS=round(steady, 3),
                    nVariants=nVariants, raysPerScene=raysPerScene,
                    bestRadius=best)


STAGES = [
    ('headline', sceneHeadline),
    ('surface_source', sceneSurfaceSource),
    ('diffuse_scatter', sceneDiffuseScatter),
    ('conditioned_dirac', sceneConditionedDirac),
    ('coupled_scatter', sceneCoupledScatter),
    ('mesh_fold', sceneMeshFold),
    ('spectrometer', sceneSpectrometer),
    ('mesh_dish', sceneMeshDish),
    ('mesh_dish_coherent', sceneMeshDishCollimated),
    ('mesh_dish_1800', sceneMeshDish1800),
    ('mesh_dish_5k', sceneMeshDish5k),
    ('mesh_dish_12k', sceneMeshDish12k),
    ('torus_mirror', sceneTorusMirror),
    ('surf_wall', sceneSurfWall),
    ('surf_5k', sceneSurf5k),
]


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--json', default=None, help='also write results here')
  ap.add_argument('--only', default=None,
                  help='comma-separated subset of stage names')
  ap.add_argument('--rays-per-step', type=int, default=1 << 22)
  args = ap.parse_args()
  only = set(args.only.split(',')) if args.only else None
  dev = jax.devices()[0]
  device = dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()))
  if dev.platform == 'gpu':
    device['card'] = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
  print(f'device: {device}', flush=True)

  results = {}
  for name, builder in STAGES:
    if only and name not in only:
      continue
    scene, maxI, bounds = builder()
    rate, meta = measureHistScene(scene, maxI, bounds,
                                  raysPerStep=args.rays_per_step)
    results[name] = dict(segmentsPerSecond=rate, **meta)
    print(f'{name:18s} {rate/1e9:8.4f} G seg/s  compile '
          f'{meta["compileS"]:.1f}s', flush=True)

  if only is None or 'sweep_batched' in only:
    rate, meta = measureSweepBatched()
    results['sweep_batched'] = dict(raysPerSecond=rate, **meta)
    print(f'{"sweep_batched":18s} {rate/1e6:8.1f} M rays/s  cold '
          f'{meta["coldS"]:.1f}s', flush=True)

  if args.json:
    with open(args.json, 'w') as f:
      json.dump(dict(device=device, results=results), f, indent=1)
    print(f'wrote {args.json}', flush=True)


if __name__ == '__main__':
  main()
