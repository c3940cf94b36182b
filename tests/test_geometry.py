'''
Exactness tests for the analytic surface intersection kernels vs closed-form
solutions (SURVEY.md build plan step 2).
'''

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import intersect as I


def ray(o, d):
  d = np.asarray(d, dtype=float)
  return (jnp.asarray(o, dtype=jnp.float32),
          jnp.asarray(d / np.linalg.norm(d), dtype=jnp.float32))


def hit_t(table, o, d, tMin=1e-6, maxLen=1e6, medium=-1, distTol=1e-5):
  t = I.allDistances(table, o, d, tMin)
  idx, tHit, has = I.selectNearest(t, table['elem'], medium, distTol, maxLen)
  return int(idx), float(tHit), bool(has)


class TestPlane:

  def test_axis_hit(self):
    tab = S.buildSurfaceTable([
        S.plane(T.translation(0, 0, 10), elem=0, radius=5.)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    idx, t, has = hit_t(tab, o, d)
    assert has and abs(t - 10) < 1e-4

  def test_trim_disc_miss(self):
    tab = S.buildSurfaceTable([
        S.plane(T.translation(0, 0, 10), elem=0, radius=5.)])
    o, d = ray([7, 0, 0], [0, 0, 1])
    _, _, has = hit_t(tab, o, d)
    assert not has

  def test_annulus(self):
    tab = S.buildSurfaceTable([
        S.plane(T.translation(0, 0, 10), elem=0, radius=5., innerRadius=2.)])
    o, d = ray([1, 0, 0], [0, 0, 1])
    assert not hit_t(tab, o, d)[2]
    o, d = ray([3, 0, 0], [0, 0, 1])
    assert hit_t(tab, o, d)[2]

  def test_rect(self):
    tab = S.buildSurfaceTable([
        S.plane(T.translation(0, 0, 10), elem=0, halfExtents=(2., 1.))])
    assert hit_t(tab, *ray([1.5, 0.5, 0], [0, 0, 1]))[2]
    assert not hit_t(tab, *ray([1.5, 1.5, 0], [0, 0, 1]))[2]

  def test_tilted_plane(self):
    # plane tilted 45 deg about x, ray along z from origin at distance 10
    m = T.compose(T.translation(0, 0, 10), T.rotation((1, 0, 0), 45))
    tab = S.buildSurfaceTable([S.plane(m, elem=0, radius=50.)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    idx, t, has = hit_t(tab, o, d)
    assert has and abs(t - 10) < 1e-3

  def test_behind_ray_ignored(self):
    tab = S.buildSurfaceTable([
        S.plane(T.translation(0, 0, -10), elem=0, radius=5.)])
    assert not hit_t(tab, *ray([0, 0, 0], [0, 0, 1]))[2]


class TestSphere:

  def test_two_roots_nearest(self):
    tab = S.buildSurfaceTable([
        S.sphere(T.translation(0, 0, 20), elem=0, radius=5.)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    idx, t, has = hit_t(tab, o, d)
    assert has and abs(t - 15) < 1e-3

  def test_inside_sphere(self):
    tab = S.buildSurfaceTable([
        S.sphere(T.translation(0, 0, 0), elem=0, radius=5.)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    idx, t, has = hit_t(tab, o, d)
    assert has and abs(t - 5) < 1e-4

  def test_cap_trim(self):
    # only keep the z>4 cap; central ray hits it at z=+5 going up,
    # but a ray going down misses (exit z=-5 not in cap)
    tab = S.buildSurfaceTable([
        S.sphere(T.translation(0, 0, 0), elem=0, radius=5., zRange=(4., 5.))])
    assert abs(hit_t(tab, *ray([0, 0, 0], [0, 0, 1]))[1] - 5) < 1e-4
    assert not hit_t(tab, *ray([0, 0, 0], [0, 0, -1]))[2]

  def test_oblique_exact(self):
    # ray from (-10, 1, 0) along +x against sphere radius 3 at origin:
    # x = -sqrt(9-1) -> t = 10 - sqrt(8)
    tab = S.buildSurfaceTable([S.sphere(np.eye(4), elem=0, radius=3.)])
    idx, t, has = hit_t(tab, *ray([-10, 1, 0], [1, 0, 0]))
    assert has and abs(t - (10 - np.sqrt(8))) < 1e-3

  def test_grazing_miss(self):
    tab = S.buildSurfaceTable([S.sphere(np.eye(4), elem=0, radius=3.)])
    assert not hit_t(tab, *ray([-10, 3.001, 0], [1, 0, 0]))[2]


class TestCylinder:

  def test_exact(self):
    tab = S.buildSurfaceTable([
        S.cylinder(np.eye(4), elem=0, radius=2., zRange=(-5, 5))])
    idx, t, has = hit_t(tab, *ray([-10, 0, 0], [1, 0, 0]))
    assert has and abs(t - 8) < 1e-4

  def test_z_trim(self):
    tab = S.buildSurfaceTable([
        S.cylinder(np.eye(4), elem=0, radius=2., zRange=(-5, 5))])
    assert not hit_t(tab, *ray([-10, 0, 7], [1, 0, 0]))[2]


class TestAsphere:

  def test_reduces_to_sphere(self):
    # asphere with k=0 equals a sphere of radius R touching origin
    R = 50.
    tab = S.buildSurfaceTable([
        S.asphere(np.eye(4), elem=0, curvature=1 / R, conic=0., rMax=20.)])
    sph = S.buildSurfaceTable([
        S.sphere(T.translation(0, 0, R), elem=0, radius=R)])
    for (ox, oy) in [(0, 0), (5, 3), (-8, 2)]:
      o, d = ray([ox, oy, -30], [0, 0, 1])
      tA = hit_t(tab, o, d)[1]
      tS = hit_t(sph, o, d)[1]
      assert abs(tA - tS) < 1e-2

  def test_parabola_exact(self):
    # paraboloid z = r^2/(4f) with f=25 -> c = 1/(2f) = 0.02, k=-1
    f = 25.
    tab = S.buildSurfaceTable([
        S.asphere(np.eye(4), elem=0, curvature=1 / (2 * f), conic=-1.,
                  rMax=40.)])
    o, d = ray([10, 0, -10], [0, 0, 1])
    idx, t, has = hit_t(tab, o, d)
    zExpect = 10 ** 2 / (4 * f)
    assert has and abs((-10 + t) - zExpect) < 1e-3

  def test_aperture_trim(self):
    tab = S.buildSurfaceTable([
        S.asphere(np.eye(4), elem=0, curvature=0.02, conic=-1., rMax=5.)])
    assert not hit_t(tab, *ray([10, 0, -10], [0, 0, 1]))[2]

  @pytest.mark.parametrize('conic,curv', [(-1., 0.02), (0., 0.015),
                                          (-0.6, 0.02), (-2.5, 0.01),
                                          (-1., -0.02)])
  def test_conic_quadric_refit_matches_newton(self, conic, curv):
    '''A pure-conic asphere is refit to an exact QUADRIC at table build
    (surfaces._conicAsQuadric); distances and normals must agree with the
    Newton ASPHERE path everywhere on the face, including the radial trim
    edge and the annular inner trim.'''
    surf = S.asphere(np.eye(4), elem=0, curvature=curv, conic=conic,
                     rMax=20., rMin=2.)
    tab = S.buildSurfaceTable([dict(surf)])
    assert int(tab['kind'][0]) == S.QUADRIC
    zs = -30. if curv > 0 else 30.
    rng = np.random.default_rng(7)
    misses = hits = 0
    for _ in range(60):
      ox, oy = rng.uniform(-25, 25, 2)
      tilt = rng.uniform(-0.1, 0.1, 2)
      o, d = ray([ox, oy, zs], [tilt[0], tilt[1], -np.sign(zs)])
      tQ = float(I.allDistances(tab, o, d, 1e-6)[0])
      tA = float(S.intersectLocal(jnp.int32(S.ASPHERE),
                                  jnp.asarray(surf['params']),
                                  jnp.asarray(surf['trim']), o, d, 1e-6))
      if np.isfinite(tA) or np.isfinite(tQ):
        assert np.isfinite(tA) and np.isfinite(tQ), (tA, tQ, ox, oy)
        assert abs(tA - tQ) < 1e-3, (tA, tQ, ox, oy)
        pQ = np.asarray(o + tQ * d)
        nQ = np.asarray(S.normalLocal(jnp.int32(S.QUADRIC),
                                      tab['params'][0], jnp.asarray(pQ)))
        nA = np.asarray(S.normalLocal(jnp.int32(S.ASPHERE),
                                      jnp.asarray(surf['params']),
                                      jnp.asarray(pQ)))
        assert np.allclose(nQ, nA, atol=1e-4), (nQ, nA)
        hits += 1
      else:
        misses += 1
    assert hits > 5 and misses > 0  # both branches exercised

  @pytest.mark.parametrize('conic,curv', [(-1., 0.02), (-1., -0.02),
                                          (-2.5, 0.01)])
  def test_conic_quadric_refit_infinite_rmax(self, conic, curv):
    '''k <= -1 conics with UNBOUNDED rMax refit to a QUADRIC with a
    one-sided infinite z band (the conjugate hyperboloid sheet lies on
    the opposite z side), instead of staying on the Newton ASPHERE
    path.'''
    surf = S.asphere(np.eye(4), elem=0, curvature=curv, conic=conic,
                     rMax=np.inf)
    tab = S.buildSurfaceTable([dict(surf)])
    assert int(tab['kind'][0]) == S.QUADRIC
    zs = -30. if curv > 0 else 30.
    # distances agree with the Newton path on a finite-aperture twin
    finite = S.asphere(np.eye(4), elem=0, curvature=curv, conic=conic,
                       rMax=50.)
    for ox in (0., 3., 17., 33.):
      o, d = ray([ox, 0, zs], [0, 0, -np.sign(zs)])
      tQ = float(I.allDistances(tab, o, d, 1e-6)[0])
      tA = float(S.intersectLocal(jnp.int32(S.ASPHERE),
                                  jnp.asarray(finite['params']),
                                  jnp.asarray(finite['trim']), o, d, 1e-6))
      assert np.isfinite(tQ) and abs(tQ - tA) < 1e-3, (ox, tQ, tA)
    # far beyond any plausible finite aperture the surface still exists
    o, d = ray([300., 0, 0], [0, 0, np.sign(curv)])
    assert np.isfinite(float(I.allDistances(tab, o, d, 1e-6)[0]))
    # rays crossing only the conjugate sheet never hit (k < -1 two-sheet
    # case): the sheet through z = apex = 2/(c(1+k)) extends AWAY from
    # z = 0, outside the one-sided band
    if conic < -1.:
      apexZ = 2. / (curv * (1. + conic))
      o, d = ray([0., 0., apexZ + (apexZ - 0.) * 0.1], [1., 0., 0.])
      assert not np.isfinite(float(I.allDistances(tab, o, d, 1e-6)[0]))


class TestTriangle:

  def test_hit_and_barycentric_miss(self):
    tab = S.buildSurfaceTable([
        S.triangle([0, 0, 5], [4, 0, 5], [0, 4, 5], elem=0)])
    assert abs(hit_t(tab, *ray([1, 1, 0], [0, 0, 1]))[1] - 5) < 1e-4
    assert not hit_t(tab, *ray([3, 3, 0], [0, 0, 1]))[2]


class TestNormalsAndSelection:

  def test_sphere_normal_entering(self):
    tab = S.buildSurfaceTable([S.sphere(T.translation(0, 0, 20), elem=0,
                                        radius=5.)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    t = I.allDistances(tab, o, d, 1e-6)
    idx, tHit, has = I.selectNearest(t, tab['elem'], -1, 1e-5, 1e6)
    p = o + tHit * d
    n, entering = I.hitNormal(tab, idx, p, d)
    assert bool(entering)
    # forward normal points along travel: at front of sphere that is +z
    assert float(n[2]) > 0.99

  def test_sphere_normal_exiting(self):
    tab = S.buildSurfaceTable([S.sphere(np.eye(4), elem=0, radius=5.)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    t = I.allDistances(tab, o, d, 1e-6)
    idx, tHit, has = I.selectNearest(t, tab['elem'], -1, 1e-5, 1e6)
    p = o + tHit * d
    n, entering = I.hitNormal(tab, idx, p, d)
    assert not bool(entering)
    assert float(n[2]) > 0.99

  def test_orient_flip(self):
    tab = S.buildSurfaceTable([S.plane(T.translation(0, 0, 10), elem=0,
                                       radius=5., orient=-1)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    t = I.allDistances(tab, o, d, 1e-6)
    idx, tHit, _ = I.selectNearest(t, tab['elem'], -1, 1e-5, 1e6)
    n, entering = I.hitNormal(tab, idx, o + tHit * d, d)
    # plane canonical normal +z, orient -1 -> outward -z, i.e. the solid
    # lies above the plane: a ray travelling +z is entering it, and the
    # forward normal (flipped against outward) points +z
    assert bool(entering) and float(n[2]) > 0.99

  def test_same_medium_preference(self):
    # two coincident-ish planes of different elements within 2*distTol:
    # ray currently inside elem 0 must pick elem 1
    tab = S.buildSurfaceTable([
        S.plane(T.translation(0, 0, 10.0), elem=0, radius=5.),
        S.plane(T.translation(0, 0, 10.00001), elem=1, radius=5.),
    ])
    o, d = ray([0, 0, 0], [0, 0, 1])
    t = I.allDistances(tab, o, d, 1e-6)
    idx, tHit, has = I.selectNearest(t, tab['elem'], 0, distTol=1e-3,
                                     maxRayLength=1e6)
    assert int(tab['elem'][idx]) == 1
    # without medium (vacuum=-1) the closest (elem 0) wins
    idx2, _, _ = I.selectNearest(t, tab['elem'], -1, 1e-3, 1e6)
    assert int(tab['elem'][idx2]) == 0

  def test_max_ray_length(self):
    tab = S.buildSurfaceTable([S.plane(T.translation(0, 0, 100), elem=0,
                                       radius=5.)])
    o, d = ray([0, 0, 0], [0, 0, 1])
    t = I.allDistances(tab, o, d, 1e-6)
    _, _, has = I.selectNearest(t, tab['elem'], -1, 1e-5, maxRayLength=50.)
    assert not bool(has)

  def test_batched_vmap(self):
    tab = S.buildSurfaceTable([S.sphere(T.translation(0, 0, 20), elem=0,
                                        radius=5.)])
    N = 1024
    o = jnp.zeros((N, 3), dtype=jnp.float32)
    d = jnp.tile(jnp.array([0., 0., 1.], dtype=jnp.float32), (N, 1))

    @jax.jit
    def run(o, d):
      def one(o, d):
        t = I.allDistances(tab, o, d, 1e-6)
        return I.selectNearest(t, tab['elem'], -1, 1e-5, 1e6)[1]
      return jax.vmap(one)(o, d)

    ts = run(o, d)
    assert np.allclose(np.asarray(ts), 15., atol=1e-3)


class TestQuadric:
  '''QUADRIC kind (principal-axis quadrics; geometry/brep.py refits scaled
  NURBS onto it — reference traces such faces through OCC directly,
  ray.py:357-383).'''

  def _ellipsoid(self, a=4., b=2., c=3., zRange=None):
    # x^2/a^2 + y^2/b^2 + z^2/c^2 = 1, scaled so max coeff = 1
    coeffs = np.array([1. / a ** 2, 1. / b ** 2, 1. / c ** 2, 0., -1.])
    coeffs = coeffs / coeffs[:3].max()
    return S.buildSurfaceTable([S.quadric(
        np.eye(4), elem=0, coeffs=tuple(coeffs),
        zRange=(-c, c) if zRange is None else zRange)])

  def test_ellipsoid_axis_hits(self):
    tab = self._ellipsoid()
    # along +x from outside: hits at x=-4 first
    idx, t, has = hit_t(tab, *ray([-10, 0, 0], [1, 0, 0]))
    assert has and abs(t - 6.) < 1e-4
    # along +y: semi-axis 2
    _, t, has = hit_t(tab, *ray([0, -10, 0], [0, 1, 0]))
    assert has and abs(t - 8.) < 1e-4
    # along +z: semi-axis 3
    _, t, has = hit_t(tab, *ray([0, 0, -10], [0, 0, 1]))
    assert has and abs(t - 7.) < 1e-4

  def test_ellipsoid_off_axis_exact(self):
    a, b, c = 4., 2., 3.
    tab = self._ellipsoid(a, b, c)
    o = np.array([1., 0.5, -10.])
    _, t, has = hit_t(tab, *ray(o, [0, 0, 1]))
    # analytic: z = -c*sqrt(1 - x^2/a^2 - y^2/b^2)
    zs = -c * np.sqrt(1 - o[0] ** 2 / a ** 2 - o[1] ** 2 / b ** 2)
    assert has and abs((o[2] + t) - zs) < 1e-4

  def test_z_band_trim(self):
    tab = self._ellipsoid(4., 2., 3., zRange=(1., 3.))
    # equator hit excluded by the band
    assert not hit_t(tab, *ray([-10, 0, 0], [1, 0, 0]))[2]
    # cap hit inside the band
    assert hit_t(tab, *ray([0, 0, 10], [0, 0, -1]))[2]

  def test_normal_matches_gradient(self):
    a, b, c = 4., 2., 3.
    tab = self._ellipsoid(a, b, c)
    o, d = ray([1., 0.5, -10.], [0, 0, 1])
    idx, t, has = hit_t(tab, o, d)
    assert has
    p = np.asarray(o) + t * np.asarray(d)
    n, entering = I.hitNormal(tab, jnp.asarray(idx), jnp.asarray(p),
                              jnp.asarray(d))
    g = np.array([2 * p[0] / a ** 2, 2 * p[1] / b ** 2, 2 * p[2] / c ** 2])
    g /= np.linalg.norm(g)
    n = np.asarray(n)
    # forward normal: same line as the gradient
    assert abs(abs(float(n @ g)) - 1.) < 1e-4
    assert bool(entering)

  def test_sphere_equivalence(self):
    '''A quadric with qa=qb=qc matches the SPHERE kind to float precision.'''
    R = 5.
    quad = S.buildSurfaceTable([S.quadric(
        np.eye(4), elem=0, coeffs=(1., 1., 1., 0., -R * R),
        zRange=(-R, R))])
    sph = S.buildSurfaceTable([S.sphere(np.eye(4), elem=0, radius=R)])
    rng = np.random.default_rng(3)
    for _ in range(20):
      o = rng.normal(size=3) * 10
      d = rng.normal(size=3)
      if np.linalg.norm(o) < R + 0.5:
        continue
      oj, dj = ray(o, d)
      _, tq, hq = hit_t(quad, oj, dj)
      _, ts, hs = hit_t(sph, oj, dj)
      assert hq == hs
      if hq:
        assert abs(tq - ts) < 1e-3

  def test_elliptic_cylinder(self):
    # x^2/9 + y^2/4 = 1 extruded along z
    tab = S.buildSurfaceTable([S.quadric(
        np.eye(4), elem=0, coeffs=(1. / 9, 1. / 4, 0., 0., -1.),
        zRange=(-5., 5.))])
    _, t, has = hit_t(tab, *ray([-10, 0, 0], [1, 0, 0]))
    assert has and abs(t - 7.) < 1e-4
    _, t, has = hit_t(tab, *ray([0, -10, 1], [0, 1, 0]))
    assert has and abs(t - 8.) < 1e-4
    assert not hit_t(tab, *ray([0, -10, 6], [0, 1, 0]))[2]

  def test_paraboloid_linear_ray(self):
    # z = (x^2 + y^2) / 4  ->  0.25 x^2 + 0.25 y^2 - z = 0 (qz = -1 after
    # scaling so max quadratic coeff is 0.25 -> normalize by 0.25)
    tab = S.buildSurfaceTable([S.quadric(
        np.eye(4), elem=0, coeffs=(1., 1., 0., -4., 0.),
        zRange=(0., 10.))])
    # axial ray straight down the axis: the quadratic degenerates to
    # linear (a == 0); must still hit the vertex
    _, t, has = hit_t(tab, *ray([0, 0, 10], [0, 0, -1]))
    assert has and abs(t - 10.) < 1e-3
    # off-axis vertical ray: z = r^2/4
    _, t, has = hit_t(tab, *ray([2, 0, 10], [0, 0, -1]))
    assert has and abs((10. - t) - 1.) < 1e-3


class TestTorus:
  '''TORUS kind: exact quartic (Ferrari + Newton polish) vs closed-form and
  brute-force numpy polyroots (reference delegates tori to OCC's
  line.Curve.intersect, ray.py:357-383).'''

  def test_equator_hits(self):
    tab = S.buildSurfaceTable([S.torus(np.eye(4), elem=0,
                                       majorRadius=10., minorRadius=2.)])
    # from the center out along +x: inner equator at R - r = 8
    _, t, has = hit_t(tab, *ray([0, 0, 0], [1, 0, 0]))
    assert has and abs(t - 8.) < 1e-3
    # from far outside in: outer equator at x = 12 -> t = 38
    _, t, has = hit_t(tab, *ray([-50, 0, 0], [1, 0, 0]))
    assert has and abs(t - 38.) < 1e-3
    # vertical ray through the tube top: z = +/-2 at s = R
    _, t, has = hit_t(tab, *ray([10, 0, 50], [0, 0, -1]))
    assert has and abs(t - 48.) < 1e-3
    # through the hole: miss
    assert not hit_t(tab, *ray([0, 0, 50], [0, 0, -1]))[2]
    # fully outside: miss
    assert not hit_t(tab, *ray([0, 30, 0], [1, 0, 0]))[2]

  def test_vband_trim(self):
    # keep only the OUTER half of the tube: v in (-pi/2, pi/2)
    tab = S.buildSurfaceTable([S.torus(np.eye(4), elem=0, majorRadius=10.,
                                       minorRadius=2.,
                                       vRange=(-1.5707, 1.5707))])
    # inner equator (v = pi) is trimmed away -> first hit is the FAR
    # outer equator? no: ray +x from center passes inner (8, trimmed),
    # then the far side of the tube at x = 12 (v = 0 on the far side is
    # at x = 12? the far tube is centered at x = -10... take the near
    # tube's outer point x = 12
    _, t, has = hit_t(tab, *ray([0, 0, 0], [1, 0, 0]))
    assert has and abs(t - 12.) < 1e-3
    # vertical ray at s = R hits z = +2 with v = +pi/2 boundary...
    # use s slightly outside R so v < pi/2 strictly
    _, t, has = hit_t(tab, *ray([11, 0, 50], [0, 0, -1]))
    assert has

  def test_normals_and_orientation(self):
    tab = S.buildSurfaceTable([S.torus(np.eye(4), elem=0,
                                       majorRadius=10., minorRadius=2.)])
    p = jnp.asarray([12., 0., 0.])
    n = S.normalLocal(jnp.int32(S.TORUS), tab['params'][0], p)
    assert np.allclose(np.asarray(n), [1., 0., 0.], atol=1e-5)
    p = jnp.asarray([8., 0., 0.])
    n = S.normalLocal(jnp.int32(S.TORUS), tab['params'][0], p)
    assert np.allclose(np.asarray(n), [-1., 0., 0.], atol=1e-5)
    p = jnp.asarray([0., 10., 2.])
    n = S.normalLocal(jnp.int32(S.TORUS), tab['params'][0], p)
    assert np.allclose(np.asarray(n), [0., 0., 1.], atol=1e-5)

  def test_random_rays_vs_polyroots(self):
    R, r = 25., 6.
    tab = S.buildSurfaceTable([S.torus(np.eye(4), elem=0,
                                       majorRadius=R, minorRadius=r)])
    rng = np.random.default_rng(7)
    checked = 0
    for i in range(300):
      o = rng.uniform(-60, 60, 3)
      # aim at a random point of the tube so most rays genuinely hit
      u, v = rng.uniform(-np.pi, np.pi, 2)
      aim = np.array([(R + r * np.cos(v)) * np.cos(u),
                      (R + r * np.cos(v)) * np.sin(u),
                      r * np.sin(v)]) + rng.normal(scale=1.0, size=3)
      dv = aim - o
      dv /= np.linalg.norm(dv)
      # brute force: numpy quartic roots in double precision
      K = o @ o + R * R - r * r
      b2 = 2 * (o @ dv)
      coeffs = [1.,
                2 * b2,
                b2 * b2 + 2 * K - 4 * R * R * (dv[0] ** 2 + dv[1] ** 2),
                2 * b2 * K - 8 * R * R * (o[0] * dv[0] + o[1] * dv[1]),
                K * K - 4 * R * R * (o[0] ** 2 + o[1] ** 2)]
      # note K here folds |o|^2: recompute exactly as the quartic of
      # (t^2 + b2 t + C)^2 = 4R^2((ox+t dx)^2 + (oy+t dy)^2), C = K
      roots = np.roots(coeffs)
      real = sorted(float(x.real) for x in roots
                    if abs(x.imag) < 1e-8 and x.real > 1e-6)
      _, t, has = hit_t(tab, *ray(o, dv))
      if not real:
        assert not has, f'ray {i}: device hit {t}, numpy says miss'
        continue
      # skip near-grazing rays (double roots) — f32 boundary cases
      g = np.polyval(np.polyder(coeffs), real[0])
      if abs(g) < 1e2:
        continue
      checked += 1
      assert has, f'ray {i}: device miss, numpy hit at {real[0]}'
      assert abs(t - real[0]) < 5e-3 * max(1., real[0]), \
          f'ray {i}: device {t} vs numpy {real[0]}'
    assert checked > 120   # the sweep must actually exercise hits

  def test_placed_torus_roundtrip(self):
    # rotate + translate the torus; a ray aimed at the placed outer
    # equator must hit at the right world point
    tf = T.translation(5., -3., 40.) @ T.rotation((1., 0., 0.), 90.)
    tab = S.buildSurfaceTable([S.torus(tf, elem=0,
                                       majorRadius=10., minorRadius=2.)])
    # the ring circle now lives in the world x-z plane (local z -> -y);
    # outer equator point local (12, 0, 0) -> world (17, -3, 40). Hit it
    # RADIALLY (a +z ray would graze the tube tangentially there):
    _, t, has = hit_t(tab, *ray([50., -3., 40.], [-1, 0, 0]))
    assert has and abs(t - 33.) < 2e-3


def test_torus_intersect_gradient_matches_fd():
  '''jax.grad through the torus quartic (Ferrari + branch-free Newton)
  matches finite differences for a hitting ray — the sqrt-at-zero
  cotangent trap in the factorization is guarded (tracing/diff.py
  differentiates through this sweep).'''
  import jax
  tab = S.buildSurfaceTable([S.torus(np.eye(4), elem=0,
                                     majorRadius=10., minorRadius=2.)])

  def f(oz):
    o = jnp.array([0., 0., oz])
    d = jnp.array([1., 0., 0.05])
    d = d / jnp.linalg.norm(d)
    return I.allDistances(tab, o, d, 1e-6)[0]

  g = float(jax.grad(f)(0.3))
  eps = 1e-3
  fd = float((f(0.3 + eps) - f(0.3 - eps)) / (2 * eps))
  assert np.isfinite(g)
  assert abs(g - fd) < 1e-3 * max(1., abs(fd))


# ---------------------------------------------------------------- snapping

class TestSnapSignedPermGroups:

  def test_rigid_part_faces_share_group(self):
    '''Face frames of one rigid part (axis perms of a common base, composed
    through float chains) snap to EXACT signed row copies of the first
    member, and the grouping survives the f32 table cast.'''
    base = T.rotation((1, 2, 3), 17)[:3, :3]
    perms = [np.eye(3),
             np.array([[0., 0., 1.], [0., 1., 0.], [-1., 0., 0.]]),
             np.array([[1., 0., 0.], [0., 0., -1.], [0., 1., 0.]]),
             -np.eye(3)]
    rots = [p @ base + np.random.default_rng(4).normal(0, 5e-8, (3, 3))
            for p in perms]
    snapped, gid = T.snapSignedPermGroups(rots)
    assert len(set(gid.tolist())) == 1
    rep32 = snapped[0].astype(np.float32)
    for i, p in enumerate(perms):
      got32 = snapped[i].astype(np.float32)
      want32 = np.asarray([[np.float32(s) * rep32[j]
                            for j in range(3) if abs(p[r, j]) > .5][0]
                           for r, s in ((r, p[r, np.abs(p[r]).argmax()])
                                        for r in range(3))])
      assert np.array_equal(got32, want32), i

  def test_axis_aligned_snaps_to_world(self):
    '''Rotations within tol of a signed perm of identity join group 0 and
    become exact 0/+-1 entries (free world-frame picks in the kernel).'''
    r = T.rotation((0, 1, 0), 90)[:3, :3] + 1e-8
    snapped, gid = T.snapSignedPermGroups([r])
    assert gid[0] == 0
    assert set(np.abs(snapped[0]).ravel().tolist()) <= {0., 1.}

  def test_distinct_rotations_keep_groups(self):
    '''A deliberate misalignment far beyond tol must NOT be snapped.'''
    a = T.rotation((0, 1, 0), 45)[:3, :3]
    b = T.rotation((0, 1, 0), 45.01)[:3, :3]    # ~1.7e-4 rad apart
    snapped, gid = T.snapSignedPermGroups([a, b])
    assert gid[0] != gid[1]
    assert np.allclose(snapped[1], b)

  def test_snap_moves_rotations_by_at_most_tol(self):
    rng = np.random.default_rng(11)
    base = T.rotation(rng.normal(size=3), 33.3)[:3, :3]
    noisy = T.rotation((0, 0, 1), 90)[:3, :3] @ base \
        + rng.normal(0, 1e-7, (3, 3))
    snapped, gid = T.snapSignedPermGroups([base, noisy])
    assert gid[0] == gid[1]
    assert np.max(np.abs(snapped[1] - noisy)) < 5e-7
