'''
Differentiable scene parameters (tracing/diff.py): functional parameter
application preserves the forward trace exactly, gradients through the
full multi-bounce tracer match finite differences, and gradient descent
focuses a lens — the capability the reference's derivative-free scipy
optimizer (parameter_sweeper.py:700-918) cannot provide.
'''

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optics_design_workbench import benchmarks
from optics_design_workbench.models import Scene, PointSource, OpticalGroup
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.tracing import diff as D
from optics_design_workbench.tracing.tracer import trace


@pytest.fixture(scope='module')
def benchSetup():
  scene = benchmarks.buildLensMirrorScene(tmpdir=None)
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  batch = src.deviceGenerator()(jax.random.PRNGKey(0), 1024)
  return device, info, batch


def lensSpecs(device, axis=(0., 0., 1.)):
  elems = np.asarray(device['surfaces']['elem']).tolist()
  return [('translate', i, axis) for i, e in enumerate(elems) if e == 0]


class TestApplyParams:

  def test_zero_params_is_identity(self, benchSetup):
    device, info, batch = benchSetup
    specs = lensSpecs(device) + [('refrIndex', 0),
                                 ('surfaceParam', 3, 0),
                                 ('rotate', 1, (1., 0., 0.), (0., 0., 60.))]
    sc = D.applyParams(device, specs, jnp.zeros(len(specs)))
    kw = dict(maxIntersections=6, maxRayLength=1e6, distTol=1e-4,
              recordSegments=False)
    _s0, rec0 = trace(device, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'], **kw)
    _s1, rec1 = trace(sc, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'], **kw)
    for k in ('hitElem', 'point', 'power', 'recordHit'):
      np.testing.assert_array_equal(np.asarray(rec0[k]), np.asarray(rec1[k]),
                                    err_msg=k)

  def test_translate_moves_all_views(self, benchSetup):
    device, _info, _batch = benchSetup
    sc = D.applyParams(device, [('translate', 3, (0., 0., 1.))],
                       jnp.array([2.5]))
    s0, s1 = device['surfaces'], sc['surfaces']
    np.testing.assert_allclose(np.asarray(s1['l2wOff'][3])
                               - np.asarray(s0['l2wOff'][3]),
                               (0., 0., 2.5), atol=1e-6)
    # packed row and byKind slice must match the flat arrays
    np.testing.assert_allclose(
        np.asarray(s1['packed'][3, S.PACKED_OFF:S.PACKED_OFF + 3]),
        np.asarray(s1['w2lOff'][3]), atol=1e-6)
    kinds = np.asarray(s0['kind']).tolist()
    name = S._KIND_NAMES[kinds[3]]
    local = kinds[:3].count(kinds[3])
    np.testing.assert_allclose(np.asarray(s1['byKind'][name]['w2lOff'][local]),
                               np.asarray(s1['w2lOff'][3]), atol=1e-6)


class TestGradients:

  def test_bench_scene_grad_matches_fd(self, benchSetup):
    device, info, batch = benchSetup
    specs = lensSpecs(device)
    lg = D.makeSpotLoss(device, specs, batch, detectorElem=2,
                        maxIntersections=6)
    p0 = jnp.zeros(len(specs))
    v0, g0 = lg(p0)
    assert np.isfinite(float(v0)) and np.isfinite(np.asarray(g0)).all()
    eps = 1e-3
    e = jnp.ones(len(specs))
    fd = (float(lg(p0 + eps * e)[0]) - float(lg(p0 - eps * e)[0])) / (2 * eps)
    an = float(jnp.dot(g0, e))
    assert abs(fd - an) / max(abs(fd), 1e-9) < 2e-2, (fd, an)

  def test_refrindex_grad_matches_fd(self, benchSetup):
    device, info, batch = benchSetup
    lg = D.makeSpotLoss(device, [('refrIndex', 0)], batch, detectorElem=2,
                        maxIntersections=6)
    p0 = jnp.zeros(1)
    _v, g = lg(p0)
    # small eps: larger n-steps kick rays across discrete hit boundaries
    # (f32 + TIR edges) and corrupt the FD itself, not the gradient
    eps = 1e-4
    fd = (float(lg(p0 + eps)[0]) - float(lg(p0 - eps)[0])) / (2 * eps)
    assert abs(fd - float(g[0])) / max(abs(fd), 1e-9) < 2e-2, (fd, float(g[0]))


class TestOptimize:

  def test_gradient_descent_focuses_detector(self, tmp_path):
    '''Collimated-ish beam through a plano-convex lens: optimize the
    DETECTOR distance by gradient descent until the spot shrinks to near
    the focus. The merit decreases monotonically-ish and ends far below
    the start.'''
    scene = Scene(label='focus', path=str(tmp_path / 'focus'))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Lens', Label='L', RefractiveIndex=1.5,
        surfaces=[S.sphere(np.eye(4), elem=0, radius=100.,
                           zRange=(95., 100.), orient=+1),
                  S.plane(T.translation(0, 0, 95.), elem=0,
                          radius=31.225, orient=-1)],
        placements=[T.translation(0, 0, -60)]))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Det',
        surfaces=[S.plane(np.eye(4), elem=1, halfExtents=(120., 120.))],
        placements=[T.translation(0, 0, 120)]))
    scene.addSource(PointSource(Label='Src', PowerDensity='1',
                                ThetaDomain='0, pi/40'))
    scene.addSimulationSettings(RaysPerIteration=64, MaxIntersections=5,
                                MaxRayLength=2000)
    device, info = scene.compile()
    src = scene.lightSources()[0]
    batch = src.deviceGenerator()(jax.random.PRNGKey(1), 512)
    specs = [('translate', 1, (0., 0., 1.))]   # detector plane, kind-sorted
    elems = np.asarray(device['surfaces']['elem']).tolist()
    assert elems[1] == 1                       # row 1 is the detector
    lg = D.makeSpotLoss(device, specs, batch, detectorElem=1,
                        maxIntersections=5, maxRayLength=2000.)
    v0 = float(lg(jnp.zeros(1))[0])
    bestP, history = D.optimizeGradient(lg, jnp.zeros(1), steps=60,
                                        learningRate=5.)
    vBest = min(v for _s, v in history)
    assert vBest < 0.25 * v0, (v0, vBest)
    assert np.isfinite(float(bestP[0]))


class TestGroupSpecs:

  def test_translate_group_matches_per_surface(self, benchSetup):
    '''One ('translateGroup', elem, axis) entry equals per-surface
    translate specs sharing the same value — the rigid-body design unit
    ("move the lens").'''
    device, _info, batch = benchSetup
    lg1 = D.makeSpotLoss(device, [('translateGroup', 0, (0., 0., 1.))],
                         batch, detectorElem=2, maxIntersections=6)
    perSurf = lensSpecs(device)
    lgN = D.makeSpotLoss(device, perSurf, batch, detectorElem=2,
                         maxIntersections=6)
    dz = 1.7
    v1, g1 = lg1(jnp.array([dz]))
    vN, gN = lgN(jnp.full(len(perSurf), dz))
    np.testing.assert_allclose(float(v1), float(vN), rtol=1e-6)
    np.testing.assert_allclose(float(g1[0]), float(np.asarray(gN).sum()),
                               rtol=1e-4)

  def test_rotate_group_identity_at_zero(self, benchSetup):
    device, _info, batch = benchSetup
    lg = D.makeSpotLoss(device, [('rotateGroup', 1, (1., 0., 0.),
                                  (0., 0., 60.))],
                        batch, detectorElem=2, maxIntersections=6)
    v, g = lg(jnp.zeros(1))
    assert np.isfinite(float(v)) and np.isfinite(float(g[0]))
    # the ~25 mm^2 loss is float32 (ulp ~2e-6): at eps = 1e-4 rounding
    # alone moves the central difference by ~1e-2, the size of the slope
    # itself; at 1e-3 it stays ~1e-3 while the O(eps^2) term is negligible
    eps = 1e-3
    fd = (float(lg(jnp.array([eps]))[0])
          - float(lg(jnp.array([-eps]))[0])) / (2 * eps)
    assert abs(fd - float(g[0])) / max(abs(fd), 1e-9) < 2e-2, (fd,
                                                               float(g[0]))


class TestGratingRotation:

  def makeScene(self, extraRotDeg=0., ruling=(0.6, 0.8, 0.)):
    scene = Scene(label='gratrot')
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Grating', Label='G', GratingType='Reflection',
        GratingLinesPerMillimeter=600., GratingDiffractionOrder=1,
        GratingLinesOrientation=ruling,
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(40., 40.),
                          orient=-1)],
        placements=[T.compose(T.translation(0, 0, 100),
                              T.rotation((1, 0, 0), 15. + extraRotDeg))]))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Det',
        surfaces=[S.sphere(T.translation(0, 0, 100), elem=0, radius=300.,
                           orient=-1)],
        placements=[np.eye(4)]))
    scene.addSource(PointSource(Label='Src', PowerDensity='1',
                                ThetaDomain='0, 0.1', Wavelength=532.))
    scene.addSimulationSettings(RaysPerIteration=64, MaxIntersections=3,
                                MaxRayLength=2000)
    return scene

  def test_rotate_group_matches_recompile(self):
    '''Default rotateGroup on a grating must equal recompiling the scene
    with a rotated placement: GratingLinesOrientation is a WORLD-FIXED
    property in the reference (ray.py:449 reads it untransformed), so the
    ruling must NOT co-rotate by default — even when the rotation axis is
    not parallel to it.'''
    angleDeg = 7.
    base = self.makeScene()
    device0, _ = base.compile()
    src = base.lightSources()[0]
    batch = src.deviceGenerator()(jax.random.PRNGKey(4), 512)

    # grating surface row: planes sort first; the grating plane is row 0
    pivot = (0., 0., 100.)
    sc = D.applyParams(device0,
                       [('rotateGroup', 0, (1., 0., 0.), pivot)],
                       jnp.array([np.deg2rad(angleDeg)]))

    ref = self.makeScene(extraRotDeg=angleDeg)
    deviceR, _ = ref.compile()

    kw = dict(maxIntersections=3, maxRayLength=2000., distTol=1e-4,
              recordSegments=False)
    _s1, recA = trace(sc, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'], **kw)
    _s2, recB = trace(deviceR, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'], **kw)
    np.testing.assert_array_equal(np.asarray(recA['hitElem']),
                                  np.asarray(recB['hitElem']))
    np.testing.assert_allclose(np.asarray(recA['point']),
                               np.asarray(recB['point']), atol=2e-3)
    np.testing.assert_allclose(np.asarray(recA['direction']),
                               np.asarray(recB['direction']), atol=1e-5)

  def test_co_rotate_ruling_equals_rotated_property(self):
    '''('rotateGroup', ..., 'coRotateRuling') must equal recompiling with
    BOTH the placement and the GratingLinesOrientation property rotated —
    the rulings-etched-on-the-element physical semantics.'''
    angleDeg = 9.
    base = self.makeScene()
    device0, _ = base.compile()
    src = base.lightSources()[0]
    batch = src.deviceGenerator()(jax.random.PRNGKey(6), 512)
    pivot = (0., 0., 100.)
    sc = D.applyParams(
        device0,
        [('rotateGroup', 0, (1., 0., 0.), pivot, 'coRotateRuling')],
        jnp.array([np.deg2rad(angleDeg)]))

    rot = T.rotation((1., 0., 0.), angleDeg)[:3, :3]
    ref = self.makeScene(extraRotDeg=angleDeg,
                         ruling=tuple(rot @ np.array([0.6, 0.8, 0.])))
    deviceR, _ = ref.compile()
    kw = dict(maxIntersections=3, maxRayLength=2000., distTol=1e-4,
              recordSegments=False)
    _s1, recA = trace(sc, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'], **kw)
    _s2, recB = trace(deviceR, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'], **kw)
    np.testing.assert_allclose(np.asarray(recA['direction']),
                               np.asarray(recB['direction']), atol=1e-5)
    # and it genuinely differs from the world-fixed default
    scDefault = D.applyParams(device0,
                              [('rotateGroup', 0, (1., 0., 0.), pivot)],
                              jnp.array([np.deg2rad(angleDeg)]))
    _s3, recC = trace(scDefault, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'], **kw)
    assert np.abs(np.asarray(recA['direction'])
                  - np.asarray(recC['direction'])).max() > 1e-3

  def test_grating_angle_gradient_matches_fd(self):
    '''d(spot)/d(grating angle) through the Ludwig diffraction formula —
    the AD path the evanescent-guard double-where keeps NaN-free.'''
    base = self.makeScene()
    device0, _ = base.compile()
    src = base.lightSources()[0]
    batch = src.deviceGenerator()(jax.random.PRNGKey(8), 512)
    lg = D.makeSpotLoss(device0,
                        [('rotateGroup', 0, (1., 0., 0.), (0., 0., 100.))],
                        batch, detectorElem=1, maxIntersections=3,
                        maxRayLength=2000.)
    p0 = jnp.zeros(1)
    _v, g = lg(p0)
    assert np.isfinite(float(g[0])) and abs(float(g[0])) > 1e-3
    eps = 1e-4
    fd = (float(lg(p0 + eps)[0]) - float(lg(p0 - eps)[0])) / (2 * eps)
    assert abs(fd - float(g[0])) / max(abs(fd), 1e-9) < 2e-2, (fd,
                                                               float(g[0]))
