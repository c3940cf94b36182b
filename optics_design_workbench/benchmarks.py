'''
Benchmark scenes and step builders: the headline
scene mirrors examples/2-lens-and-mirror — Gaussian point source ->
plano-convex lens -> 45deg fold mirror -> absorbing detector — so every ray
traces ~4 segments with refraction, reflection and medium tracking on the
path, plus the simpler examples/1 source->detector scene.
'''

import numpy as np

from .models import Scene, PointSource, OpticalGroup
from .geometry import surfaces as S
from .geometry import transforms as T
from .tracing import fused


def buildSourceDetectorScene(tmpdir=None):
  '''examples/1-source-and-detector analog.'''
  scene = Scene(label='bench1', path=tmpdir and f'{tmpdir}/bench1')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', Wavelength=532.,
      ThetaResolutionNumericMode='2e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=2)
  return scene


def buildLensMirrorScene(tmpdir=None):
  '''examples/2-lens-and-mirror analog: lens at z=50 focuses the beam, a
  45 deg fold mirror at z=150 bends it to +x, detector plane at x=100.'''
  scene = Scene(label='bench2', path=tmpdir and f'{tmpdir}/bench2')
  R, aperture, thickness = 60., 25., 6.
  sagMax = R - np.sqrt(R ** 2 - aperture ** 2)
  lens = OpticalGroup(
      OpticalType='Lens', Label='Lens', RefractiveIndex=1.5,
      surfaces=[
          S.sphere(T.translation(0, 0, R), elem=0, radius=R,
                   zRange=(-R, -R + sagMax + 1e-6), orient=+1),
          S.plane(T.translation(0, 0, thickness), elem=0, radius=aperture,
                  orient=+1),
          S.cylinder(T.translation(0, 0, thickness / 2), elem=0,
                     radius=aperture, zRange=(-thickness / 2, thickness / 2),
                     orient=+1),
      ],
      placements=[T.translation(0, 0, 50)])
  scene.addOpticalGroup(lens)
  mirror = OpticalGroup(
      OpticalType='Mirror', Label='FoldMirror', Reflectivity=0.98,
      surfaces=[S.plane(np.eye(4), elem=0, radius=40.)],
      placements=[T.compose(T.translation(0, 0, 150),
                            T.rotation((0, 1, 0), 45))])
  scene.addOpticalGroup(mirror)
  detector = OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.compose(T.translation(-100, 0, 150),
                            T.rotation((0, 1, 0), 90))])
  scene.addOpticalGroup(detector)
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.35', Wavelength=532.,
      ThetaResolutionNumericMode='2e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=6)
  return scene


def buildSurfaceSourceScene(tmpdir=None):
  '''Lambertian-emitter benchmark: a cos(theta)^2 disc emitter radiating
  onto a detector plane past a fold mirror — the reference's surface-source
  use case (surface_source.py:269-555) on the fused device path.'''
  scene = Scene(label='bench_ss', path=tmpdir and f'{tmpdir}/bench_ss')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Emitter',
      surfaces=[S.plane(np.eye(4), elem=0, radius=20.)],
      placements=[T.translation(0, 0, 0)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='FoldMirror', Reflectivity=0.98,
      surfaces=[S.plane(np.eye(4), elem=0, radius=80.)],
      placements=[T.compose(T.translation(0, 0, 120),
                            T.rotation((0, 1, 0), 45))]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(120., 120.))],
      placements=[T.compose(T.translation(-100, 0, 120),
                            T.rotation((0, 1, 0), 90))]))
  from .models.surface_source import SurfaceSource
  src = SurfaceSource(Label='Source', ActiveSurfaces=['Emitter'],
                      PowerDensity='cos(theta)**2')
  scene.addSource(src)
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene


def buildMixedInteractionScene():
  '''Device scene dict exercising every interaction type at once:
  absorbing lens (sphere + plane + cylinder rim), tilted mirror,
  reflection grating, an aspheric pass-through detector and an absorbing
  detector. Rays launched from the origin towards +z cross all of them;
  used to hold the batch tracer to the per-ray oracle.'''
  from . import tracing
  surfs = [
      S.sphere(T.translation(0, 0, 60), elem=0, radius=30.,
               zRange=(-30., -20.), orient=+1),
      S.plane(T.translation(0, 0, 45), elem=0, radius=25., orient=+1),
      S.cylinder(T.translation(0, 0, 40), elem=0, radius=25.,
                 zRange=(-5, 5), orient=+1),
      S.plane(T.compose(T.translation(0, 0, 100),
                        T.rotation((0, 1, 0), 30)), elem=1, radius=80.),
      S.plane(T.compose(T.translation(0, 0, 120),
                        T.rotation((1, 0, 0), 10)), elem=2, radius=90.,
              orient=-1),
      S.asphere(T.translation(0, 0, 140), elem=3, curvature=0.01,
                conic=-1., rMax=60.),
      S.plane(T.translation(0, 0, 180), elem=4, halfExtents=(200., 200.)),
  ]
  elems = [
      tracing.element('Lens', refractiveIndex=1.7, absorptionLength=40.),
      tracing.element('Mirror', reflectivity=0.9),
      tracing.element('Grating', gratingType='Reflection',
                      gratingLinesPerMillimeter=600.,
                      gratingLinesOrientation=(1, 0, 0)),
      tracing.element('Vacuum', recordHits=True),
      tracing.element('Absorber', recordHits=True),
  ]
  return dict(surfaces=S.buildSurfaceTable(surfs),
              elements=tracing.buildElementTable(elems), powerTol=1e-6)


def mixedInteractionRays(key, n, maxAngle=0.4):
  '''(origins, directions) of n rays from the origin into the cone of
  half-angle maxAngle around +z (the rays of buildMixedInteractionScene).'''
  import jax
  import jax.numpy as jnp
  k1, k2 = jax.random.split(key)
  ang = jax.random.uniform(k1, (n,), minval=-maxAngle, maxval=maxAngle)
  phi = jax.random.uniform(k2, (n,), minval=0, maxval=2 * np.pi)
  d = jnp.stack([jnp.sin(ang) * jnp.cos(phi), jnp.sin(ang) * jnp.sin(phi),
                 jnp.cos(ang)], axis=-1)
  return jnp.zeros((n, 3), jnp.float32), d


def oracleAgreement(ref, test):
  '''Agreement of two bounce-major record sets of the same rays (e.g.
  tracing.traceReference vs tracing.trace): the fraction of rays whose
  hit-element sequence is identical over all bounces, and over those rays
  the largest hit-point distance and relative power difference.'''
  elemR = np.asarray(ref['hitElem'])
  elemT = np.asarray(test['hitElem'])
  same = np.all(elemR == elemT, axis=0)                 # (N,)
  hit = (elemR >= 0) & same[None, :]
  pR = np.asarray(ref['point'], np.float64)[hit]
  pT = np.asarray(test['point'], np.float64)[hit]
  wR = np.asarray(ref['power'], np.float64)[hit]
  wT = np.asarray(test['power'], np.float64)[hit]
  dist = np.linalg.norm(pR - pT, axis=-1)
  rel = np.abs(wR - wT) / np.maximum(np.abs(wR), 1e-30)
  return dict(sameElementFraction=float(same.mean()),
              maxPointDistance=float(dist.max()) if dist.size else 0.,
              maxPowerRelDiff=float(rel.max()) if rel.size else 0.)


def makeBenchStep(scene=None, raysPerStep=1 << 20, maxIntersections=6,
                  mesh=None, bins=(256, 256), stratified=False,
                  bounds=(-60., 60., -60., 60.)):
  '''Compile the fused sample+trace+histogram step for a benchmark scene
  (the step `runSimulation` builds in histogram mode). Returns
  (step, histograms, meta) with step: (key, hist) -> (hist, counters).
  With a `mesh` the ray batch is sharded over its devices
  (parallel.makeShardedFusedStep).'''
  if scene is None:
    scene = buildLensMirrorScene()
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  gen = src.deviceGenerator()
  histSpec = fused.makeHistogramSpec(device, info, bounds=bounds,
                                     bins=bins)
  hist = fused.initHistograms(histSpec)
  settings = scene.activeSimulationSettings()
  kwargs = dict(raysPerStep=raysPerStep,
                maxIntersections=maxIntersections,
                maxRayLength=settings.maxRayLength(),
                distTol=settings.deviceDistanceTolerance(),
                stratified=stratified)
  if mesh is None:
    step = fused.makeFusedStep(device, gen, histSpec, **kwargs)
  else:
    from .parallel import makeShardedFusedStep
    step = makeShardedFusedStep(mesh, device, gen, histSpec, **kwargs)
  return step, hist, dict(scene=scene, device=device, info=info,
                          histSpec=histSpec)


def perShardReference(meta, key, nShards, raysPerStep, maxIntersections):
  '''What a sharded bench step (makeBenchStep with a mesh of nShards
  devices) computes, run shard after shard on the default device: shard i
  samples with fold_in(split(key, nShards)[i], i) and traces its
  raysPerStep // nShards rays; histograms and counters are summed.
  Returns (histograms, counters) as numpy / python numbers.'''
  import jax
  device, histSpec = meta['device'], meta['histSpec']
  gen = meta['scene'].lightSources()[0].deviceGenerator()
  settings = meta['scene'].activeSimulationSettings()
  perShard = raysPerStep // nShards

  @jax.jit
  def shard(k):
    batch = gen(k, perShard)
    return fused.traceHistogram(
        device, histSpec, fused.initHistograms(histSpec),
        batch['origins'], batch['directions'], batch['powers'],
        batch['wavelengths'], maxIntersections=maxIntersections,
        maxRayLength=settings.maxRayLength(),
        distTol=settings.deviceDistanceTolerance())

  keys = jax.random.split(key, nShards)
  parts = [shard(jax.random.fold_in(keys[i], i)) for i in range(nShards)]
  hist = {k: sum(np.asarray(h[k], np.float64) for h, _ in parts)
          for k in ('power', 'counts')}
  counters = {k: sum(int(c[k]) for _, c in parts)
              for k in ('hits', 'segments')}
  return hist, counters
