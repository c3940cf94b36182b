'''
Surface light source — rays emitted from the faces of scene geometry with an
angular power density in theta per surface element (reference:
freecad_elements/surface_source.py):

  * ActiveSurfaces: whole optical groups or individual face indices
    (surface_source.py:35-37, 437-457),
  * area-correct position sampling: faces chosen with probability
    proportional to their area, positions drawn from the area-element
    density dA over the face parametrization (:269-410). Our faces are
    *analytic* surfaces, so most kinds sample area-exactly in closed form
    (plane disc/rect, sphere zone, cylinder, triangle); aspheres tabulate
    dA(r) into a 1-D inverse-CDF like the reference's UV grids,
  * PowerDensity in theta only (default Lambertian-like cos(theta)**2,
    :38-43); phi uniform; direction = Rot(normal, phi) Rot(tangent, theta)
    normal (:85-111),
  * fan mode: deterministic approx-uniform surface grids with the {1,4,9}
    per-face ray quantization and face skipping when the budget is exceeded
    (:469-517); rays launched along the face normal (theta=0).
'''

import numpy as np
import jax
import jax.numpy as jnp

from .. import distributions
from ..distributions.device_sampler import buildDeviceTables, deviceDraw
from ..geometry import surfaces as GS
from ..utils import io
from .common import parseDomain
from .generic_source import GenericSource


def _torusTubeAngleCdf(face, quantileRes=257):
  '''Inverse CDF v(u) of the torus tube-angle area element
  dA ~ (R + r cos v) dv on the face's v band, tabulated on a uniform
  quantile grid (same plumbing as the asphere rInv table).'''
  R0, rT = float(face.params[0]), float(face.params[1])
  v1 = max(float(face.trim[1]), -np.pi)
  v2 = min(float(face.trim[2]), np.pi)
  vGrid = np.linspace(v1, v2, 2001)
  cdf = R0 * (vGrid - v1) + rT * (np.sin(vGrid) - np.sin(v1))
  cdf /= cdf[-1]
  return np.interp(np.linspace(0., 1., quantileRes), cdf, vGrid)


def _asphereRadiusCdf(face, quantileRes=257):
  '''Inverse CDF r(u) of the area element dA(r) of an asphere face,
  tabulated on a uniform quantile grid (the device twin of the host
  samplePositions asphere branch).'''
  t = face.trim
  r1, r2 = t[1], min(t[2], 1e6)
  rGrid = np.linspace(r1, r2, 2001)
  gr = face._sagPrimeOverR(rGrid ** 2) * rGrid
  dens = 2 * np.pi * rGrid * np.sqrt(1 + gr ** 2)
  cdf = np.concatenate([[0], np.cumsum((dens[1:] + dens[:-1]) / 2
                                       * np.diff(rGrid))])
  cdf /= cdf[-1]
  return np.interp(np.linspace(0., 1., quantileRes), cdf, rGrid)


def _localSampleColumns(face, u, v, rCol=None):
  '''Column-math local position + canonical normal for one face kind from
  two uniforms, in closed form per kind (aspheres and tori take their
  tabulated parameter column `rCol`). `face` is
  a dict of PYTHON floats; u, v are jnp columns. Returns
  (lx, ly, lz, nlx, nly, nlz) with the orient flip NOT yet applied.'''
  k = face['kind']
  p = face['params']
  t = face['trim']
  one = jnp.ones_like(u)
  zero = jnp.zeros_like(u)
  if k == GS.PLANE:
    if t[0] > 0.5:
      return ((2. * u - 1.) * t[1], (2. * v - 1.) * t[2], zero,
              zero, zero, one)
    r = jnp.sqrt(u * (t[2] ** 2 - t[1] ** 2) + t[1] ** 2)
    a = 2. * np.pi * v
    return r * jnp.cos(a), r * jnp.sin(a), zero, zero, zero, one
  if k == GS.SPHERE:
    R = p[0]
    z = t[1] + u * (t[2] - t[1])
    a = 2. * np.pi * v
    rr = jnp.sqrt(jnp.maximum(R ** 2 - z * z, 0.))
    lx, ly = rr * jnp.cos(a), rr * jnp.sin(a)
    inv = 1.0 / R
    return lx, ly, z, lx * inv, ly * inv, z * inv
  if k == GS.CYLINDER:
    R = p[0]
    z = t[1] + u * (t[2] - t[1])
    a = 2. * np.pi * v
    ca, sa = jnp.cos(a), jnp.sin(a)
    return R * ca, R * sa, z, ca, sa, zero
  if k == GS.CONE:
    r0, tanA = p[0], p[1]
    z1, z2 = t[1], t[2]
    A1 = r0 * z1 + tanA * z1 * z1 / 2.
    A2 = r0 * z2 + tanA * z2 * z2 / 2.
    target = A1 + u * (A2 - A1)
    if abs(tanA) < 1e-12:
      z = z1 + u * (z2 - z1)
    else:
      disc = jnp.maximum(r0 ** 2 + 2. * tanA * target, 0.)
      z = (-r0 + jnp.sqrt(disc)) * (1.0 / tanA)
    a = 2. * np.pi * v
    ca, sa = jnp.cos(a), jnp.sin(a)
    rr = r0 + z * tanA
    ninv = 1.0 / np.sqrt(1. + tanA * tanA)
    return (rr * ca, rr * sa, z,
            ca * ninv, sa * ninv, zero - tanA * ninv)
  if k == GS.ASPHERE:
    r = rCol      # supplied by the caller (interp table or pwpoly)
    a = 2. * np.pi * v
    c0, kk = p[0], p[1]
    a4, a6, a8 = p[2], p[3], p[4]
    r2 = r * r
    root = jnp.sqrt(jnp.maximum(1. - (1. + kk) * c0 * c0 * r2, 1e-12))
    sag = c0 * r2 / (1. + root) + r2 * r2 * (a4 + r2 * (a6 + r2 * a8))
    g = (c0 * (2. / (1. + root)
               + (1. + kk) * c0 * c0 * r2 / (root * (1. + root) ** 2))
         + 4. * a4 * r2 + 6. * a6 * r2 * r2 + 8. * a8 * r2 ** 3)
    ca, sa = jnp.cos(a), jnp.sin(a)
    ninv = jax.lax.rsqrt(g * g * r2 + 1. + 1e-20)
    return (r * ca, r * sa, sag,
            -g * r * ca * ninv, -g * r * sa * ninv, ninv)
  if k == GS.TORUS:
    vT = rCol     # tube angle from the tabulated inverse area CDF
    a = 2. * np.pi * v
    R0, rT = p[0], p[1]
    ca, sa = jnp.cos(a), jnp.sin(a)
    cv, sv = jnp.cos(vT), jnp.sin(vT)
    rad = R0 + rT * cv
    return (rad * ca, rad * sa, rT * sv,
            cv * ca, cv * sa, sv)
  if k == GS.TRIANGLE:
    v0 = np.array(p[0:3])
    v1 = np.array(p[3:6])
    v2 = np.array(p[6:9])
    flip = u + v > 1.
    a = jnp.where(flip, 1. - u, u)
    b = jnp.where(flip, 1. - v, v)
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm = nrm / np.linalg.norm(nrm)
    return (v0[0] + a * (v1[0] - v0[0]) + b * (v2[0] - v0[0]),
            v0[1] + a * (v1[1] - v0[1]) + b * (v2[1] - v0[1]),
            v0[2] + a * (v1[2] - v0[2]) + b * (v2[2] - v0[2]),
            nrm[0] * one, nrm[1] * one, nrm[2] * one)
  raise ValueError(f'unknown surface kind {k}')


def _rodrigues(v, axis, angle):
  axis = axis / np.linalg.norm(axis)
  c, s = np.cos(angle), np.sin(angle)
  return (v * c + np.cross(axis, v) * s
          + axis * (axis @ v) * (1 - c))


class _Face:
  '''Host-side sampling adapter for one analytic surface instance.'''

  def __init__(self, spec, placement):
    self.spec = spec
    self.transform = np.asarray(placement, float) @ \
        np.asarray(spec['transform'], float)
    self.kind = spec['kind']
    self.params = np.asarray(spec['params'], float)
    self.trim = np.asarray(spec['trim'], float)
    self.orient = float(spec['orient'])

  # ------------------------------------------------------------------- area

  def area(self):
    k, p, t = self.kind, self.params, self.trim
    if k == GS.PLANE:
      if t[0] > 0.5:
        return 4 * t[1] * t[2]
      rOut = t[2] if np.isfinite(t[2]) else 0.
      return np.pi * (rOut ** 2 - t[1] ** 2)
    if k == GS.SPHERE:
      return 2 * np.pi * p[0] * (t[2] - t[1])     # zone area = 2 pi R dz
    if k == GS.CYLINDER:
      return 2 * np.pi * p[0] * (t[2] - t[1])
    if k == GS.ASPHERE:
      r1, r2 = t[1], min(t[2], 1e6)
      r = np.linspace(r1, r2, 2001)
      g = self._sagPrimeOverR(r ** 2) * r
      return float(np.trapezoid(2 * np.pi * r * np.sqrt(1 + g ** 2), r))
    if k == GS.TRIANGLE:
      v0, v1, v2 = p[0:3], p[3:6], p[6:9]
      return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0))
    if k == GS.CONE:
      # dA = 2 pi r(z) sqrt(1 + tanA^2) dz with r(z) = r0 + z tanA
      r0, tanA = p[0], p[1]
      z1, z2 = t[1], t[2]
      return float(2 * np.pi * np.sqrt(1 + tanA ** 2)
                   * (r0 * (z2 - z1) + tanA * (z2 ** 2 - z1 ** 2) / 2))
    if k == GS.TORUS:
      # dA = r (R + r cos v) du dv, u full circle, v band
      R0, rT = p[0], p[1]
      v1, v2 = max(t[1], -np.pi), min(t[2], np.pi)
      return float(2 * np.pi * rT
                   * (R0 * (v2 - v1) + rT * (np.sin(v2) - np.sin(v1))))
    raise ValueError(f'unknown surface kind {k}')

  def _sagPrimeOverR(self, r2):
    c, kk = self.params[0], self.params[1]
    a4, a6, a8 = self.params[2], self.params[3], self.params[4]
    root = np.sqrt(np.maximum(1 - (1 + kk) * c * c * r2, 1e-12))
    return (c * (2 / (1 + root) + (1 + kk) * c * c * r2
                 / (root * (1 + root) ** 2))
            + 4 * a4 * r2 + 6 * a6 * r2 * r2 + 8 * a8 * r2 ** 3)

  # -------------------------------------------------- local points + normals

  def samplePositions(self, n, rng):
    '''(n,3) local points distributed with uniform area density, plus local
    normals (n,3) (canonical, orient applied).'''
    k, p, t = self.kind, self.params, self.trim
    u = rng.random(n)
    v = rng.random(n)
    if k == GS.PLANE:
      if t[0] > 0.5:
        pts = np.stack([(2 * u - 1) * t[1], (2 * v - 1) * t[2],
                        np.zeros(n)], -1)
      else:
        r = np.sqrt(u * (t[2] ** 2 - t[1] ** 2) + t[1] ** 2)
        phi = 2 * np.pi * v
        pts = np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros(n)], -1)
      normals = np.tile([0., 0., 1.], (n, 1))
    elif k == GS.SPHERE:
      R = p[0]
      z = t[1] + u * (t[2] - t[1])      # uniform z = uniform zone area
      phi = 2 * np.pi * v
      rr = np.sqrt(np.maximum(R ** 2 - z ** 2, 0.))
      pts = np.stack([rr * np.cos(phi), rr * np.sin(phi), z], -1)
      normals = pts / R
    elif k == GS.CYLINDER:
      R = p[0]
      z = t[1] + u * (t[2] - t[1])
      phi = 2 * np.pi * v
      pts = np.stack([R * np.cos(phi), R * np.sin(phi), z], -1)
      normals = np.stack([np.cos(phi), np.sin(phi), np.zeros(n)], -1)
    elif k == GS.ASPHERE:
      r1, r2 = t[1], min(t[2], 1e6)
      rGrid = np.linspace(r1, r2, 2001)
      gr = self._sagPrimeOverR(rGrid ** 2) * rGrid
      dens = 2 * np.pi * rGrid * np.sqrt(1 + gr ** 2)
      cdf = np.concatenate([[0], np.cumsum((dens[1:] + dens[:-1]) / 2
                                           * np.diff(rGrid))])
      cdf /= cdf[-1]
      r = np.interp(u, cdf, rGrid)
      phi = 2 * np.pi * v
      r2v = r ** 2
      z = self._sag(r2v)
      pts = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
      g = self._sagPrimeOverR(r2v)
      normals = np.stack([-g * r * np.cos(phi), -g * r * np.sin(phi),
                          np.ones(n)], -1)
      normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    elif k == GS.TRIANGLE:
      v0, v1, v2 = p[0:3], p[3:6], p[6:9]
      a, b = u, v
      flip = a + b > 1
      a = np.where(flip, 1 - a, a)
      b = np.where(flip, 1 - b, b)
      pts = v0 + a[:, None] * (v1 - v0) + b[:, None] * (v2 - v0)
      nrm = np.cross(v1 - v0, v2 - v0)
      normals = np.tile(nrm / np.linalg.norm(nrm), (n, 1))
    elif k == GS.CONE:
      # area density over z is linear in r(z) = r0 + z tanA: invert the
      # quadratic CDF in closed form
      r0, tanA = p[0], p[1]
      z1, z2 = t[1], t[2]
      A = lambda z: r0 * z + tanA * z * z / 2      # noqa: E731
      target = A(z1) + u * (A(z2) - A(z1))
      if abs(tanA) < 1e-12:
        z = z1 + u * (z2 - z1)
      else:
        disc = np.maximum(r0 ** 2 + 2 * tanA * target, 0.)
        z = (-r0 + np.sqrt(disc)) / tanA
      phi = 2 * np.pi * v
      rr = r0 + z * tanA
      pts = np.stack([rr * np.cos(phi), rr * np.sin(phi), z], -1)
      normals = np.stack([np.cos(phi), np.sin(phi),
                          np.full(n, -tanA)], -1)
      normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    elif k == GS.TORUS:
      vInv = _torusTubeAngleCdf(self)
      vT = np.interp(u, np.linspace(0., 1., len(vInv)), vInv)
      phi = 2 * np.pi * v
      R0, rT = p[0], p[1]
      rad = R0 + rT * np.cos(vT)
      pts = np.stack([rad * np.cos(phi), rad * np.sin(phi),
                      rT * np.sin(vT)], -1)
      normals = np.stack([np.cos(vT) * np.cos(phi),
                          np.cos(vT) * np.sin(phi), np.sin(vT)], -1)
    else:
      raise ValueError(f'unknown surface kind {k}')
    return pts, normals * self.orient

  def _sag(self, r2):
    c, kk = self.params[0], self.params[1]
    a4, a6, a8 = self.params[2], self.params[3], self.params[4]
    root = np.sqrt(np.maximum(1 - (1 + kk) * c * c * r2, 1e-12))
    return c * r2 / (1 + root) + r2 * r2 * (a4 + r2 * (a6 + r2 * a8))

  def gridPositions(self, n):
    '''Deterministic approximately-uniform surface grid of ~n points (fan
    mode, reference: surface_source.py:122-267). Returns (points, normals)
    in local frame.'''
    n = max(1, int(n))
    k, p, t = self.kind, self.params, self.trim
    if k == GS.PLANE and t[0] > 0.5:
      nx = max(1, int(round(np.sqrt(n * t[1] / t[2]))))
      ny = max(1, int(round(n / nx)))
      xs = np.linspace(-t[1], t[1], nx + 2)[1:-1]
      ys = np.linspace(-t[2], t[2], ny + 2)[1:-1]
      X, Y = np.meshgrid(xs, ys, indexing='ij')
      pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
      normals = np.tile([0., 0., 1.], (len(pts), 1))
    elif k in (GS.PLANE, GS.ASPHERE):
      # concentric rings with ring point counts proportional to radius
      rIn = t[1]
      rOut = t[2] if np.isfinite(t[2]) else 1.
      nRings = max(1, int(round(np.sqrt(n / np.pi))))
      rs = np.linspace(rIn, rOut, nRings + 1)[:-1] + \
          (rOut - rIn) / (2 * nRings + 1e-30)
      pts, normals = [], []
      total = sum(max(1, int(round(2 * np.pi * r / max(rOut - rIn, 1e-9)
                                   * nRings))) for r in rs)
      for r in rs:
        m = max(1, int(round(2 * np.pi * r / max(rOut - rIn, 1e-9)
                             * nRings * n / max(total, 1))))
        phis = np.linspace(0, 2 * np.pi, m + 1)[:-1]
        if k == GS.PLANE:
          ring = np.stack([r * np.cos(phis), r * np.sin(phis),
                           np.zeros(m)], -1)
          nrm = np.tile([0., 0., 1.], (m, 1))
        else:
          z = self._sag(np.full(m, r ** 2))
          ring = np.stack([r * np.cos(phis), r * np.sin(phis), z], -1)
          g = self._sagPrimeOverR(np.full(m, r ** 2))
          nrm = np.stack([-g * r * np.cos(phis), -g * r * np.sin(phis),
                          np.ones(m)], -1)
          nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        pts.append(ring)
        normals.append(nrm)
      pts = np.concatenate(pts)
      normals = np.concatenate(normals)
    elif k in (GS.SPHERE, GS.CYLINDER):
      R = p[0]
      span = t[2] - t[1]
      nz = max(1, int(round(np.sqrt(n * span / (2 * np.pi * R)))))
      nphi = max(1, int(round(n / nz)))
      zs = np.linspace(t[1], t[2], nz + 2)[1:-1]
      phis = np.linspace(0, 2 * np.pi, nphi + 1)[:-1]
      Z, PHI = np.meshgrid(zs, phis, indexing='ij')
      Z, PHI = Z.ravel(), PHI.ravel()
      if k == GS.SPHERE:
        rr = np.sqrt(np.maximum(R ** 2 - Z ** 2, 0.))
        pts = np.stack([rr * np.cos(PHI), rr * np.sin(PHI), Z], -1)
        normals = pts / R
      else:
        pts = np.stack([R * np.cos(PHI), R * np.sin(PHI), Z], -1)
        normals = np.stack([np.cos(PHI), np.sin(PHI),
                            np.zeros(len(PHI))], -1)
    elif k == GS.TRIANGLE:
      v0, v1, v2 = p[0:3], p[3:6], p[6:9]
      m = max(1, int(round(np.sqrt(n))))
      pts, normals = [], []
      nrm = np.cross(v1 - v0, v2 - v0)
      nrm = nrm / np.linalg.norm(nrm)
      for i in range(m):
        for j in range(m - i):
          a, b = (i + 0.5) / m, (j + 0.5) / m
          pts.append(v0 + a * (v1 - v0) + b * (v2 - v0))
          normals.append(nrm)
      pts, normals = np.array(pts), np.array(normals)
    else:
      raise ValueError(f'unknown surface kind {k}')
    return pts, normals * self.orient


class SurfaceSource(GenericSource):

  def _properties(self):
    return [
        ('OpticalEmission', [
            ('ActiveSurfaces', [],
             'list of group labels (all faces emit) or (groupLabel, '
             'surfaceIndex) pairs for individual faces (reference: '
             'surface_source.py:35-37)'),
            ('PowerDensity', 'cos(theta)**2',
             'emitted power per solid angle per surface element, in theta'),
            ('Wavelength', 500., 'emission wavelength in nm'),
            ('ThetaDomain', '0, pi/2', ''),
        ]),
        ('OpticalSimulationSettings', [
            ('RandomNumberGeneratorMode', '?', ''),
            ('ThetaResolutionNumericMode', '1e5', ''),
            ('UVSamplingInitialResolution', '5', 'parity; analytic faces '
                                                 'sample in closed form'),
            ('UVSamplingMaxRelAreaElementChange', '0.1', 'parity'),
            ('FanModeRayCount', 100,
             'total rays over all emitting faces in fan mode'),
        ]),
    ] + self._baseProperties()

  def __init__(self, scene=None, placement=None, **kwargs):
    self._scene = scene
    super().__init__(placement=placement, **kwargs)
    self._vrv = None
    self._deviceTables = None

  def attachScene(self, scene):
    self._scene = scene

  def parsedThetaDomain(self):
    return parseDomain(self.ThetaDomain, default='0,pi/2',
                       limits=('-20*pi', '20*pi'), spanLimits=(0, '20*pi'))[1]

  def _getVrv(self):
    if self._vrv is None:
      self._vrv = distributions.ScalarRandomVariable(
          self.PowerDensity, variable='theta',
          variableDomain=self.parsedThetaDomain(),
          numericalResolution=float(self.ThetaResolutionNumericMode))
      self._vrv.compile()
      self.RandomNumberGeneratorMode = self._vrv.mode()
    return self._vrv

  def _activeFaces(self):
    '''Resolve ActiveSurfaces into _Face adapters, one per (face,
    placement) instance.'''
    if self._scene is None:
      raise ValueError('SurfaceSource needs attachScene(scene) before '
                       'generating rays')
    faces = []
    for entry in self.ActiveSurfaces:
      if isinstance(entry, str):
        label, indices = entry, None
      else:
        label, indices = entry
        if np.isscalar(indices):
          indices = [indices]
      group = self._scene.getObject(label)
      specs = group.surfaces if indices is None else \
          [group.surfaces[i] for i in indices]
      for placement in group.placements:
        faces.extend(_Face(spec, placement) for spec in specs)
    if not faces:
      io.warn(f'surface source {self.Label} has no ActiveSurfaces selected '
              f'for emission')
    return faces

  def _makeBatch(self, faces, localPoints, localNormals, thetas, phis,
                 metadata):
    '''Transform per-face local samples to world rays.'''
    origins, directions = [], []
    for face, pts, nrm, th, ph in zip(faces, localPoints, localNormals,
                                      thetas, phis):
      R, off = face.transform[:3, :3], face.transform[:3, 3]
      ptsW = pts @ R.T + off
      nrmW = nrm @ R.T
      dirs = np.empty_like(nrmW)
      for i in range(len(ptsW)):
        n = nrmW[i] / np.linalg.norm(nrmW[i])
        # tangent: any stable vector orthogonal to n (reference uses the
        # face u-derivative; phi is uniform so the choice cancels out)
        ref = np.array([1., 0., 0.]) if abs(n[0]) < 0.9 \
            else np.array([0., 1., 0.])
        tang = np.cross(n, ref)
        tang /= np.linalg.norm(tang)
        d = _rodrigues(n, tang, th[i])
        d = _rodrigues(d, n, ph[i])
        dirs[i] = d
      origins.append(ptsW)
      directions.append(dirs)
    origins = np.concatenate(origins) if origins else np.zeros((0, 3))
    directions = np.concatenate(directions) if directions \
        else np.zeros((0, 3))
    n = len(origins)
    return dict(origins=origins, directions=directions,
                powers=np.ones(n),
                wavelengths=np.full(n, float(self.Wavelength)),
                metadata={k: np.concatenate(v) if len(v) else np.zeros(0)
                          for k, v in metadata.items()})

  def generateRays(self, mode, settings=None, maxFanCount=np.inf,
                   maxRaysPerFan=np.inf, rng=None):
    rng = rng or np.random.default_rng()
    faces = self._activeFaces()
    if not faces:
      return dict(origins=np.zeros((0, 3)), directions=np.zeros((0, 3)),
                  powers=np.zeros(0), wavelengths=np.zeros(0), metadata={})
    areas = np.array([f.area() for f in faces])
    weights = areas / areas.sum()

    if mode == 'fans':
      total = int(self.FanModeRayCount)

      def customRound(x):
        # {1,4,9} quantization (reference: surface_source.py:474-476)
        if x > 9:
          return int(round(x))
        return [1, 4, 9][int(np.argmin(np.abs(x - np.array([1, 4, 9]))))]

      counts = [customRound(w * total) for w in weights]
      skipFraction = max(0., 1 - total / max(sum(counts), 1))
      if skipFraction > 0.3:
        io.warn(f'cannot place rays on all surfaces within '
                f'FanModeRayCount={total}; skipping '
                f'{1e2*skipFraction:.0f}% of faces')
      pts, nrms, ths, phs = [], [], [], []
      meta = dict(initTheta=[], initPhi=[])
      faceI = 0.
      usedFaces = []
      for w, face, cnt in zip(weights, faces, counts):
        if skipFraction > 0:
          step = skipFraction / max(w * len(faces), 1e-12)
          if round(faceI) != round(faceI + step):
            faceI += step
            continue
          faceI += step
        p, nr = face.gridPositions(cnt)
        usedFaces.append(face)
        pts.append(p)
        nrms.append(nr)
        ths.append(np.zeros(len(p)))
        phs.append(np.zeros(len(p)))
        meta['initTheta'].append(np.zeros(len(p)))
        meta['initPhi'].append(np.zeros(len(p)))
      return self._makeBatch(usedFaces, pts, nrms, ths, phs, meta)

    if mode in ('true', 'pseudo'):
      raysPerIteration = 100
      if settings is not None:
        raysPerIteration = settings.raysPerIteration()
      n = max(1, int(round(raysPerIteration
                           * float(self.RaysPerIterationScale))))
      vrv = self._getVrv()
      # choose faces by area, then draw per-face positions in one batch each
      choice = rng.choice(len(faces), size=n, p=weights)
      pts, nrms, ths, phs = [], [], [], []
      meta = dict(initTheta=[], initPhi=[])
      usedFaces = []
      for fi in range(len(faces)):
        m = int(np.sum(choice == fi))
        if m == 0:
          continue
        p, nr = faces[fi].samplePositions(m, rng)
        if mode == 'pseudo':
          th = vrv.drawPseudo(N=m, rng=rng)[0] if m > 1 else \
              np.atleast_1d(vrv.draw(N=1, rng=rng))
        else:
          th = np.atleast_1d(vrv.draw(N=m, rng=rng))
        ph = rng.random(m) * 2 * np.pi
        usedFaces.append(faces[fi])
        pts.append(p)
        nrms.append(nr)
        ths.append(th)
        phs.append(ph)
        meta['initTheta'].append(th)
        meta['initPhi'].append(ph)
      return self._makeBatch(usedFaces, pts, nrms, ths, phs, meta)

    raise ValueError(f'unexpected ray placement mode {mode}')

  # ------------------------------------------------------------- device path

  def supportsDeviceSampling(self):
    try:
      return bool(self._scene is not None and self._activeFaces())
    except Exception:
      return False

  def _faceConstants(self):
    '''Per-face python-float constants for the device sampler:
    area-CDF windows, placement, kind parameters, and (aspheres) the
    tabulated inverse area CDF.'''
    faces = self._activeFaces()
    if not faces:
      return []
    areas = np.array([f.area() for f in faces])
    cum = np.concatenate([[0.], np.cumsum(areas / areas.sum())])
    cum[-1] = 1.0 + 1e-7      # catch u == 1 - ulp in the last window
    out = []
    for i, f in enumerate(faces):
      d = dict(kind=int(f.kind),
               params=tuple(float(x) for x in f.params),
               trim=tuple(float(x) for x in f.trim),
               orient=float(f.orient),
               R=tuple(tuple(float(x) for x in row)
                       for row in f.transform[:3, :3]),
               off=tuple(float(x) for x in f.transform[:3, 3]),
               cumLo=float(cum[i]), cumHi=float(cum[i + 1]))
      if f.kind == GS.ASPHERE:
        d['rInv'] = _asphereRadiusCdf(f)
      elif f.kind == GS.TORUS:
        d['rInv'] = _torusTubeAngleCdf(f)
      out.append(d)
    return out

  def deviceColumnsGenerator(self):
    '''Column-form device generator: a jittable
    `generate(key, N, stratified=False) -> dict(ox..dz, pw, wl)` sampling
    faces area-proportionally, positions area-uniformly per kind in closed
    form, theta from the compiled PowerDensity inverse CDF and phi
    uniformly — entirely on device (reference semantics:
    surface_source.py:519-555, but batch-first instead of per-ray).'''
    faces = self._faceConstants()
    if not faces:
      raise ValueError('surface source has no active faces')
    if self._deviceTables is None:
      self._deviceTables = buildDeviceTables(self._getVrv())
    tables = self._deviceTables
    wavelength = float(self.Wavelength)

    def generate(key, N, stratified=False):
      kF, kU, kV, kT, kP = jax.random.split(key, 5)
      uF = jax.random.uniform(kF, (N,))
      u = jax.random.uniform(kU, (N,))
      v = jax.random.uniform(kV, (N,))
      theta = deviceDraw(tables, kT, N, stratified=stratified)[0]
      phi = jax.random.uniform(kP, (N,)) * (2. * np.pi)
      cols = _surfaceSampleColumns(faces, uF, u, v, theta, phi, wavelength)
      cols['_theta'] = theta
      cols['_phi'] = phi
      cols['_face'] = _faceIndexColumn(faces, uF)
      return cols

    return generate

  def deviceGenerator(self):
    '''Batch-form device generator: (N,3) origins/directions + metadata
    columns (initTheta, initPhi, faceIndex) for the raw-records path.'''
    columns = self.deviceColumnsGenerator()

    def generate(key, N, stratified=False):
      c = columns(key, N, stratified=stratified)
      return dict(
          origins=jnp.stack([c['ox'], c['oy'], c['oz']], axis=-1),
          directions=jnp.stack([c['dx'], c['dy'], c['dz']], axis=-1),
          powers=c['pw'], wavelengths=c['wl'],
          metadata=dict(initTheta=c['_theta'], initPhi=c['_phi'],
                        faceIndex=c['_face']))

    return generate

def _faceIndexColumn(faces, uF):
  idx = jnp.zeros_like(uF)
  for i, f in enumerate(faces[1:], start=1):
    idx = jnp.where(uF >= f['cumLo'], float(i), idx)
  return idx


def _surfaceSampleColumns(faces, uF, u, v, theta, phi, wavelength):
  '''World-frame ray columns from the per-face constants and uniform/theta
  columns (the device generator's maths): per-face closed-form position+normal accumulated under the area-CDF
  window masks, then direction = Rot(n, phi) Rot(tangent, theta) n with
  the host's tangent convention (cross with x-hat, or y-hat near
  alignment; phi is uniform so the choice cancels).'''
  zero = jnp.zeros_like(uF)
  ox, oy, oz = zero, zero, zero
  nx, ny, nz = zero, zero, zero + 1.
  for f in faces:
    m = (uF >= f['cumLo']) & (uF < f['cumHi'])
    rCol = None
    if 'rInv' in f:       # tabulated-parameter kinds (asphere r, torus v)
      K = len(f['rInv'])
      pos = u * (K - 1)
      j = jnp.clip(pos.astype(jnp.int32), 0, K - 2)
      tab = jnp.asarray(f['rInv'], jnp.float32)
      rCol = tab[j] + (pos - j) * (tab[j + 1] - tab[j])
    lx, ly, lz, nlx, nly, nlz = _localSampleColumns(f, u, v, rCol=rCol)
    R, off, orient = f['R'], f['off'], f['orient']
    wx = R[0][0] * lx + R[0][1] * ly + R[0][2] * lz + off[0]
    wy = R[1][0] * lx + R[1][1] * ly + R[1][2] * lz + off[1]
    wz = R[2][0] * lx + R[2][1] * ly + R[2][2] * lz + off[2]
    wnx = (R[0][0] * nlx + R[0][1] * nly + R[0][2] * nlz) * orient
    wny = (R[1][0] * nlx + R[1][1] * nly + R[1][2] * nlz) * orient
    wnz = (R[2][0] * nlx + R[2][1] * nly + R[2][2] * nlz) * orient
    ox = jnp.where(m, wx, ox)
    oy = jnp.where(m, wy, oy)
    oz = jnp.where(m, wz, oz)
    nx = jnp.where(m, wnx, nx)
    ny = jnp.where(m, wny, ny)
    nz = jnp.where(m, wnz, nz)
  ninv = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz + 1e-20)
  nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
  # tangent: cross(n, x-hat) = (0, nz, -ny) unless n is nearly x-aligned,
  # then cross(n, y-hat) = (-nz, 0, nx) — the host _makeBatch convention
  useX = jnp.abs(nx) < 0.9
  tx = jnp.where(useX, zero, -nz)
  ty = jnp.where(useX, nz, zero)
  tz = jnp.where(useX, -ny, nx)
  tinv = jax.lax.rsqrt(tx * tx + ty * ty + tz * tz + 1e-20)
  tx, ty, tz = tx * tinv, ty * tinv, tz * tinv
  dx, dy, dz = _rotColumns(nx, ny, nz, tx, ty, tz, theta)
  dx, dy, dz = _rotColumns(dx, dy, dz, nx, ny, nz, phi)
  dinv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz + 1e-20)
  return dict(ox=ox, oy=oy, oz=oz,
              dx=dx * dinv, dy=dy * dinv, dz=dz * dinv,
              pw=jnp.ones_like(uF),
              wl=jnp.full_like(uF, wavelength))


def _rotColumns(vx, vy, vz, ax, ay, az, ang):
  '''Rodrigues rotation on columns (twin of batch_tracer._rot3, local to
  avoid a models -> tracing import at module load).'''
  c, s = jnp.cos(ang), jnp.sin(ang)
  cx = ay * vz - az * vy
  cy = az * vx - ax * vz
  cz = ax * vy - ay * vx
  dot = ax * vx + ay * vy + az * vz
  return (vx * c + cx * s + ax * dot * (1 - c),
          vy * c + cy * s + ay * dot * (1 - c),
          vz * c + cz * s + az * dot * (1 - c))
