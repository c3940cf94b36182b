'''
Cross-validation: the column-SoA batched bounce kernel (batch_tracer) must be
physics-identical to the per-ray reference kernel (tracer.bounceOne) on a
scene exercising every interaction type.
'''

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from functools import partial

from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import tracing as TR
from optics_design_workbench.tracing.tracer import bounceOne, VACUUM_MEDIUM
from optics_design_workbench.tracing.batch_tracer import bounceBatch


def _mixedScene():
  from optics_design_workbench import benchmarks
  return benchmarks.buildMixedInteractionScene()


def test_batch_matches_per_ray_kernel():
  scene = _mixedScene()
  N = 512
  from optics_design_workbench import benchmarks
  o, d = benchmarks.mixedInteractionRays(jax.random.PRNGKey(7), N)
  state = (o, d, jnp.ones((N,)), jnp.full((N,), 550.),
           jnp.full((N,), VACUUM_MEDIUM, jnp.int32),
           jnp.zeros((N,), jnp.int32), jnp.ones((N,), bool))

  for bounce in range(6):
    stRef, recRef = jax.vmap(partial(bounceOne, scene, 1e-4, 1000.))(*state)
    stB, recB = bounceBatch(scene, 1e-4, 1000., *state)
    np.testing.assert_allclose(np.asarray(stRef[0]), np.asarray(stB[0]),
                               atol=2e-3, err_msg=f'origin b{bounce}')
    np.testing.assert_allclose(np.asarray(stRef[1]), np.asarray(stB[1]),
                               atol=2e-4, err_msg=f'direction b{bounce}')
    np.testing.assert_allclose(np.asarray(stRef[2]), np.asarray(stB[2]),
                               atol=1e-4, err_msg=f'power b{bounce}')
    assert (np.asarray(stRef[4]) == np.asarray(stB[4])).all(), 'medium'
    assert (np.asarray(stRef[5]) == np.asarray(stB[5])).all(), 'seq'
    assert (np.asarray(stRef[6]) == np.asarray(stB[6])).all(), 'alive'
    assert (np.asarray(recRef['hitElem']) == np.asarray(recB['hitElem'])).all()
    assert (np.asarray(recRef['recordHit'])
            == np.asarray(recB['recordHit'])).all()
    assert (np.asarray(recRef['isEntering'])
            == np.asarray(recB['isEntering'])).all()
    state = stB


def test_dispersion_batch_path():
  lamGrid = np.array([400., 700.])
  nVals = np.array([1.6, 1.4])
  surfs = [
      S.plane(T.translation(0, 0, 10), elem=0, radius=100., orient=-1),
      S.plane(T.translation(0, 0, 20), elem=0, radius=100., orient=+1),
      S.plane(T.translation(0, 0, 500), elem=1, radius=1000., orient=-1),
  ]
  scene = dict(
      surfaces=S.buildSurfaceTable(surfs),
      elements=TR.buildElementTable([
          TR.element('Lens', refractiveIndex=1.5,
                     dispersion=(lamGrid, nVals)),
          TR.element('Absorber', recordHits=True)]),
      powerTol=1e-6)
  a = np.deg2rad(30)
  d = jnp.tile(jnp.array([[np.sin(a), 0., np.cos(a)]], jnp.float32), (2, 1))
  o = jnp.zeros((2, 3), jnp.float32)
  wl = jnp.array([400., 700.], jnp.float32)
  (oF, dF, *_), rec = TR.trace(scene, o, d, jnp.ones((2,)), wl,
                               maxIntersections=4, maxRayLength=1e4,
                               distTol=1e-4)
  # refraction angle inside glass differs per wavelength
  sin400 = float(np.asarray(rec['direction'])[1, 0, 0])
  sin700 = float(np.asarray(rec['direction'])[1, 1, 0])
  assert abs(sin400 - np.sin(a) / 1.6) < 1e-4
  assert abs(sin700 - np.sin(a) / 1.4) < 1e-4


def test_batch_matches_per_ray_on_quadric_prim_scene():
  '''Quadric surfaces + boolean-cut trim primitives + a triangle through
  BOTH tracers: the column-SoA batch kernel must agree with the per-ray
  reference kernel on the round-3 surface classes (quadric refits,
  trimPrims, world-space triangles).'''
  import math
  ell = np.array([1. / 400., 1. / 900., 1. / 225., 0., -1.])
  ell = ell / ell[:3].max()
  slotted = S.plane(T.translation(0, 0, 80), elem=1, radius=40.)
  slotted['trim'][0] = 3.                  # annulus base + prims
  ang = math.radians(25.)
  slotted['trimPrims'] = dict(holes=[
      (1., 0., 0., 1e7, 3., math.cos(ang), math.sin(ang)),   # slot strip
      (22., 0., 5., 35. ** 2, 0., 0., 0.),  # keep inside r=35 (inv disc)
  ])
  surfs = [
      S.quadric(T.translation(0, 0, 40), elem=0, coeffs=tuple(ell),
                zRange=(10., 15.)),
      S.plane(T.translation(0, 0, 50), elem=0, radius=16., orient=-1),
      slotted,
      S.triangle((-60., -60., 120.), (60., -60., 120.), (0., 60., 120.),
                 elem=2),
  ]
  elems = [
      TR.element('Lens', refractiveIndex=1.6),
      TR.element('Mirror', reflectivity=0.95),
      TR.element('Absorber', recordHits=True),
  ]
  scene = dict(surfaces=S.buildSurfaceTable(surfs),
               elements=TR.buildElementTable(elems),
               powerTol=1e-6)
  rng = np.random.RandomState(5)
  N = 512
  o = jnp.asarray(np.column_stack([rng.uniform(-12, 12, N),
                                   rng.uniform(-12, 12, N),
                                   np.full(N, 130.)]))
  d = jnp.asarray(np.column_stack([rng.uniform(-.15, .15, N),
                                   rng.uniform(-.15, .15, N),
                                   np.full(N, -1.)]))
  d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
  state = (o, d, jnp.ones((N,)), jnp.full((N,), 550.),
           jnp.full((N,), VACUUM_MEDIUM, dtype=jnp.int32),
           jnp.zeros((N,), dtype=jnp.int32), jnp.ones((N,), dtype=bool))
  for bounce in range(5):
    stRef, recRef = jax.vmap(partial(bounceOne, scene, 1e-4, 1000.))(*state)
    stB, recB = bounceBatch(scene, 1e-4, 1000., *state)
    for k in ('hitElem', 'recordHit', 'isHit'):
      assert np.array_equal(np.asarray(recRef[k]), np.asarray(recB[k])), \
          (bounce, k)
    np.testing.assert_allclose(np.asarray(stRef[0]), np.asarray(stB[0]),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(stRef[2]), np.asarray(stB[2]),
                               atol=1e-5)
    state = stB


def test_fused_step_ray_chunking_matches_unchunked():
  '''makeFusedStep's memory guard (lax.scan over ray chunks when
  S * raysPerStep * BYTES_PER_SURFACE_RAY exceeds memoryBudgetBytes — the
  (S, N) distance matrix runs out of device memory for big meshes
  otherwise) must be bit-identical to the unchunked
  step: same rays, same scatterless physics, chunking only reshapes the
  batch axis.'''
  import jax
  from optics_design_workbench import benchmarks
  from optics_design_workbench.tracing import fused

  scene = benchmarks.buildLensMirrorScene()
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  hs = fused.makeHistogramSpec(device, info, bounds=(-60., 60., -60., 60.),
                               bins=(32, 64))
  N = 1 << 12
  key = jax.random.PRNGKey(41)
  kw = dict(raysPerStep=N, maxIntersections=6, maxRayLength=1e6,
            distTol=1e-4)
  stepA = fused.makeFusedStep(device, src.deviceGenerator(), hs, **kw)
  hA, cA = stepA(key, fused.initHistograms(hs))
  # a tiny budget forces 8 chunks on this 5-surface scene
  stepB = fused.makeFusedStep(
      device, src.deviceGenerator(), hs, **kw,
      memoryBudgetBytes=6 * (N // 8) * fused.BYTES_PER_SURFACE_RAY)
  hB, cB = stepB(key, fused.initHistograms(hs))
  assert int(cB['hits']) == int(cA['hits'])
  assert int(cB['segments']) == int(cA['segments'])
  np.testing.assert_array_equal(np.asarray(hB['counts']),
                                np.asarray(hA['counts']))
  np.testing.assert_allclose(np.asarray(hB['power']),
                             np.asarray(hA['power']), rtol=1e-6, atol=1e-7)


def test_trace_reference_matches_trace():
  '''tracing.traceReference (the per-ray oracle, full f32 rotations)
  against tracing.trace (the batch tracer) over whole traces of the mixed
  scene: the agreement that the GPU smoke run checks at 65,536 rays.'''
  from optics_design_workbench import benchmarks
  scene = _mixedScene()
  N = 1024
  o, d = benchmarks.mixedInteractionRays(jax.random.PRNGKey(3), N)
  args = (scene, o, d, jnp.ones((N,)), jnp.full((N,), 550.))
  kw = dict(maxIntersections=6, maxRayLength=1000., distTol=1e-4)
  ref = TR.traceReference(*args, **kw)
  _state, rec = TR.trace(*args, recordSegments=False, **kw)
  agree = benchmarks.oracleAgreement(ref, rec)
  assert agree['sameElementFraction'] >= 0.999, agree
  assert agree['maxPointDistance'] <= 1e-3, agree
  assert agree['maxPowerRelDiff'] <= 1e-5, agree
  assert (np.asarray(ref["hitElem"]) >= 0).sum() >= 3 * N   # rays bounce
