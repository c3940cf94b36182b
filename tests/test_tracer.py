'''
Physics tests for the bounce-scan tracer: specular reflection, Snell
refraction + TIR, plano-convex lens focusing vs paraxial theory, parabolic
mirror focus, Beer-Lambert absorption, absorber/vacuum semantics, grating
equation, sequential mode, termination limits.
'''

import numpy as np
import jax.numpy as jnp
import pytest

from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench import tracing as TR


def scene(surfs, elems, **extra):
  sc = dict(surfaces=S.buildSurfaceTable(surfs),
            elements=TR.buildElementTable(elems))
  sc.update(extra)
  return sc


def runTrace(sc, origins, dirs, wavelengths=None, maxIntersections=8,
             maxRayLength=1e4, distTol=1e-4, powers=None):
  origins = jnp.asarray(origins, dtype=jnp.float32)
  dirs = jnp.asarray(dirs, dtype=jnp.float32)
  dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
  n = origins.shape[0]
  powers = (jnp.ones((n,), jnp.float32) if powers is None
            else jnp.asarray(powers, jnp.float32))
  wl = (jnp.full((n,), 500., jnp.float32) if wavelengths is None
        else jnp.asarray(wavelengths, jnp.float32))
  return TR.trace(sc, origins, dirs, powers, wl,
                  maxIntersections=maxIntersections,
                  maxRayLength=maxRayLength, distTol=distTol)


class TestMirror:

  def test_45deg_mirror(self):
    m = T.compose(T.translation(0, 0, 10), T.rotation((0, 1, 0), 45))
    sc = scene([S.plane(m, elem=0, radius=20.)],
               [TR.element('Mirror', reflectivity=0.8)])
    (o, d, p, wl, med, seq, alive), rec = runTrace(
        sc, [[0, 0, 0]], [[0, 0, 1]])
    # +z ray hits mirror tilted 45 deg about y -> reflected into -x or +x
    d0 = np.asarray(d[0])
    assert abs(abs(d0[0]) - 1) < 1e-5 and abs(d0[2]) < 1e-5
    assert abs(float(p[0]) - 0.8) < 1e-6
    assert np.asarray(rec['isHit'])[0, 0]

  def test_parabolic_mirror_focus(self):
    # paraboloid z = r^2/(4f), f = 25: parallel rays reflect through
    # (0, 0, f)
    f = 25.
    sc = scene([S.asphere(np.eye(4), elem=0, curvature=1 / (2 * f),
                          conic=-1., rMax=40., orient=+1)],
               [TR.element('Mirror')])
    hs = [5., 10., 20., 30.]
    origins = [[h, 0, 60] for h in hs]
    dirs = [[0, 0, -1]] * len(hs)
    (o, d, p, wl, med, seq, alive), rec = runTrace(sc, origins, dirs)
    o, d = np.asarray(o), np.asarray(d)
    # propagate each reflected ray to x=0 and check z == f
    s = -o[:, 0] / d[:, 0]
    zCross = o[:, 2] + s * d[:, 2]
    assert np.allclose(zCross, f, atol=2e-2)


class TestLens:

  def _planoConvex(self, R=50., n=1.5, thickness=5., aperture=20.,
                   absorptionLength=np.inf):
    # convex front: sphere radius R centered (0,0,R), cap around z=0
    sagMax = R - np.sqrt(R ** 2 - aperture ** 2)
    surfs = [
        S.sphere(T.translation(0, 0, R), elem=0, radius=R,
                 zRange=(-R, -R + sagMax + 1e-6), orient=+1),
        S.plane(T.translation(0, 0, thickness), elem=0, radius=aperture,
                orient=+1),
        S.cylinder(np.eye(4), elem=0, radius=aperture,
                   zRange=(0, thickness), orient=+1),
        S.plane(T.translation(0, 0, 200.), elem=1, radius=1000., orient=-1),
    ]
    elems = [TR.element('Lens', refractiveIndex=n,
                        absorptionLength=absorptionLength),
             TR.element('Absorber', recordHits=True)]
    return scene(surfs, elems)

  def test_focal_length_paraxial(self):
    R, n, t = 50., 1.5, 5.
    sc = self._planoConvex(R, n, t)
    # back focal distance from the flat rear vertex: f - t/n with f=R/(n-1)
    f = R / (n - 1)
    bfd = f - t / n
    h = 1.0
    (o, d, p, wl, med, seq, alive), rec = runTrace(
        sc, [[h, 0, -20]], [[0, 0, 1]], maxIntersections=3,
        maxRayLength=1e4)
    # after 3 bounces: front face, rear face, detector. Extract state after
    # rear-face exit from the segment records of bounce 2 (detector segment)
    o2 = np.asarray(rec['segP1'])[2, 0]   # exit point on rear face
    p2 = np.asarray(rec['segP2'])[2, 0]   # hit on detector
    dExit = (p2 - o2) / np.linalg.norm(p2 - o2)
    sAxis = -o2[0] / dExit[0]
    zCross = o2[2] + sAxis * dExit[2]
    assert abs(zCross - (t + bfd)) < 0.15
    # medium is vacuum again and ray terminated at the absorber
    assert int(med[0]) == TR.VACUUM_MEDIUM
    assert not bool(alive[0])

  def test_medium_tracking_and_hits(self):
    sc = self._planoConvex()
    (_, _, _, _, med, _, _), rec = runTrace(
        sc, [[1, 0, -20]], [[0, 0, 1]], maxIntersections=4)
    hits = np.asarray(rec['hitElem'])[:, 0]
    assert list(hits[:3]) == [0, 0, 1]
    # only the absorber records hits
    assert list(np.asarray(rec['recordHit'])[:, 0][:3]) == [False, False,
                                                            True]
    entering = np.asarray(rec['isEntering'])[:, 0]
    assert bool(entering[0]) and not bool(entering[1])

  def test_beer_lambert(self):
    t = 5.
    sc = self._planoConvex(thickness=t, absorptionLength=10.)
    (_, _, p, _, _, _, _), rec = runTrace(
        sc, [[0.5, 0, -20]], [[0, 0, 1]], maxIntersections=4)
    powerAtDetector = float(np.asarray(rec['power'])[2, 0])
    # path length inside glass ~ thickness (near-axial ray)
    assert abs(powerAtDetector - np.exp(-t / 10.)) < 0.01

  def test_total_internal_reflection(self):
    # ray inside a glass block hitting the top surface beyond the critical
    # angle (n=1.5 -> theta_c = 41.8 deg); launch at 60 deg
    surfs = [
        S.plane(T.translation(0, 0, 10), elem=0, halfExtents=(100, 100),
                orient=+1),                      # top face of the block
        S.plane(T.translation(0, 0, -10), elem=0, halfExtents=(100, 100),
                orient=-1),                      # bottom face
    ]
    sc = scene(surfs, [TR.element('Lens', refractiveIndex=1.5)])
    a = np.deg2rad(60)
    # start inside the block: first force entry through bottom? instead,
    # start in vacuum below and refract in through the bottom face at 0 deg,
    # then TIR cannot be set up easily -> directly test the snell() helper
    # for the TIR branch and the tracer for medium bookkeeping elsewhere.
    d = jnp.array([np.sin(a), 0., np.cos(a)], dtype=jnp.float32)
    nrm = jnp.array([0., 0., 1.], dtype=jnp.float32)
    out, tir = TR.snell(d, nrm, 1.5, 1.0)
    assert bool(tir)
    out = np.asarray(out)
    assert abs(out[0] - np.sin(a)) < 1e-6 and abs(out[2] + np.cos(a)) < 1e-6

  def test_snell_angle(self):
    a = np.deg2rad(30)
    d = jnp.array([np.sin(a), 0., np.cos(a)], dtype=jnp.float32)
    nrm = jnp.array([0., 0., 1.], dtype=jnp.float32)
    out, tir = TR.snell(d, nrm, 1.0, 1.5)
    assert not bool(tir)
    sinOut = float(np.asarray(out)[0])
    assert abs(sinOut - np.sin(a) / 1.5) < 1e-6


class TestAbsorberVacuum:

  def test_absorber_kills_vacuum_passes(self):
    surfs = [
        S.plane(T.translation(0, 0, 10), elem=0, radius=50.),   # vacuum det
        S.plane(T.translation(0, 0, 20), elem=1, radius=50.),   # absorber
        S.plane(T.translation(0, 0, 30), elem=2, radius=50.),   # behind
    ]
    sc = scene(surfs, [
        TR.element('Vacuum', recordHits=True),
        TR.element('Absorber', recordHits=True),
        TR.element('Absorber', recordHits=True),
    ])
    (_, _, p, _, _, _, alive), rec = runTrace(
        sc, [[0, 0, 0]], [[0, 0, 1]], maxIntersections=5)
    hits = np.asarray(rec['hitElem'])[:, 0]
    assert list(hits[:2]) == [0, 1]
    assert hits[2] == -1          # never reaches elem 2
    assert float(p[0]) == 0.


class TestGrating:

  def test_reflection_grating_equation(self):
    # normal incidence, m=1, 500 lpm -> d=2um, lambda=0.5um: sin(theta)=0.25
    # grating solid sits above the plane: outward normal faces the ray
    surfs = [S.plane(T.translation(0, 0, 10), elem=0, radius=50.,
                     orient=-1)]
    sc = scene(surfs, [TR.element(
        'Grating', gratingType='Reflection', gratingLinesPerMillimeter=500.,
        gratingDiffractionOrder=1, gratingLinesOrientation=(1, 0, 0))])
    (o, d, p, wl, med, seq, alive), rec = runTrace(
        sc, [[0, 0, 0]], [[0, 0, 1]], maxIntersections=1)
    d = np.asarray(d)[0]
    # diffracted back (reflection) with in-plane sine = m lambda / d
    assert d[2] < 0
    sinOut = np.abs(np.cross(d, [0, 0, 1.]))
    assert abs(np.linalg.norm(sinOut) - 0.25) < 1e-3

  def test_zero_order_is_specular(self):
    surfs = [S.plane(T.translation(0, 0, 10), elem=0, radius=50., orient=-1)]
    sc = scene(surfs, [TR.element(
        'Grating', gratingType='Reflection', gratingLinesPerMillimeter=500.,
        gratingDiffractionOrder=0, gratingLinesOrientation=(1, 0, 0))])
    a = np.deg2rad(20)
    (o, d, p, wl, med, seq, alive), rec = runTrace(
        sc, [[-10 * np.tan(a), 0, 0]], [[np.sin(a), 0, np.cos(a)]],
        maxIntersections=1)
    d = np.asarray(d)[0]
    assert abs(d[0] - np.sin(a)) < 1e-4 and abs(d[2] + np.cos(a)) < 1e-4


class TestTermination:

  def test_max_intersections(self):
    # two parallel mirrors bouncing a ray forever
    surfs = [
        S.plane(T.translation(0, 0, 0), elem=0, radius=50., orient=+1),
        S.plane(T.translation(0, 0, 10), elem=0, radius=50., orient=-1),
    ]
    sc = scene(surfs, [TR.element('Mirror')])
    (_, _, _, _, _, _, alive), rec = runTrace(
        sc, [[0, 0, 5]], [[0, 0, 1]], maxIntersections=7)
    assert np.asarray(rec['isHit'])[:, 0].sum() == 7
    assert int(TR.totalSegments(rec)) == 7

  def test_power_tolerance_kills(self):
    surfs = [
        S.plane(T.translation(0, 0, 0), elem=0, radius=50., orient=+1),
        S.plane(T.translation(0, 0, 10), elem=0, radius=50., orient=-1),
    ]
    sc = scene(surfs, [TR.element('Mirror', reflectivity=0.005)])
    sc['powerTol'] = 1e-6
    (_, _, p, _, _, _, alive), rec = runTrace(
        sc, [[0, 0, 5]], [[0, 0, 1]], maxIntersections=10)
    # power 0.005^k < 1e-6 after 3 bounces (0.005^3 = 1.25e-7)
    assert np.asarray(rec['isHit'])[:, 0].sum() == 3

  def test_escape_segment(self):
    surfs = [S.plane(T.translation(0, 0, 10), elem=0, radius=1.)]
    sc = scene(surfs, [TR.element('Absorber')])
    (_, _, _, _, _, _, alive), rec = runTrace(
        sc, [[5, 0, 0]], [[0, 0, 1]], maxIntersections=3, maxRayLength=77.)
    assert not np.asarray(rec['isHit'])[0, 0]
    seg = np.asarray(rec['segP2'])[0, 0] - np.asarray(rec['segP1'])[0, 0]
    assert abs(np.linalg.norm(seg) - 77.) < 1e-3
    # only one segment emitted
    assert np.asarray(rec['segValid'])[:, 0].sum() == 1


class TestSequentialMode:

  def test_masks_restrict_candidates(self):
    # two absorbers; sequential mode allows only the far one at seq=0
    surfs = [
        S.plane(T.translation(0, 0, 10), elem=0, radius=50.),
        S.plane(T.translation(0, 0, 20), elem=1, radius=50.),
    ]
    elems = [TR.element('Vacuum', recordHits=True),
             TR.element('Absorber', recordHits=True)]
    seqMask = jnp.asarray([[False, True], [True, True]])
    sc = scene(surfs, elems, seqMask=seqMask)
    (_, _, _, _, _, _, _), rec = runTrace(
        sc, [[0, 0, 0]], [[0, 0, 1]], maxIntersections=2)
    hits = np.asarray(rec['hitElem'])[:, 0]
    assert hits[0] == 1   # near vacuum detector skipped at seq index 0


class TestDispersion:

  def test_wavelength_dependent_index(self):
    lamGrid = np.array([400., 700.])
    nVals = np.array([1.6, 1.4])
    elems = [TR.element('Lens', refractiveIndex=1.5,
                        dispersion=(lamGrid, nVals))]
    table = TR.buildElementTable(elems)
    n450 = float(TR.refractiveIndex(table, jnp.int32(0), jnp.float32(450.)))
    assert abs(n450 - (1.6 + (1.4 - 1.6) * 50 / 300)) < 1e-5
