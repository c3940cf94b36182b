'''
Point light source with symbolic power density — full parity with the
reference's PointSourceProxy (reference: freecad_elements/point_source.py):

  * PowerDensity expression in theta/phi/r/x/y; FocalLength 0 (pure point),
    finite (converging/diverging through a focus) or 'inf' (collimated beam,
    cylinder-coordinate sampling); Divergence bidirectionally synced with
    FocalLength (point_source.py:197-270),
  * coordinate substitutions + Jacobians building the random variable
    (_rvArgs, point_source.py:273-362),
  * ray placement so all rays pass through the focal point / run parallel
    (_makeRay, point_source.py:407-456),
  * fan generation with the three fan modes gapped / stitched /
    theta-sign-change and (fanIndex, signed rayIndex) metadata
    (point_source.py:459-634),
  * true / pseudo Monte-Carlo modes (point_source.py:637-657).

Addition: `deviceGenerator()` exports the compiled sampler as
device tables plus a jittable (key, N) -> ray-batch function, so continuous
Monte-Carlo runs sample + trace fully on device.
'''

import numpy as np
import sympy as sy
import scipy.optimize

import jax
import jax.numpy as jnp

from .. import distributions
from ..distributions.device_sampler import buildDeviceTables, deviceDraw
from ..utils import io
from .common import parseDomain, evalExpr
from .generic_source import GenericSource


class PointSource(GenericSource):

  def _properties(self):
    return [
        ('OpticalEmission', [
            ('PowerDensity', 'exp(-theta^2/0.01)',
             'emitted optical power per solid angle; variables theta, phi, '
             'r, x, y (point_source.py:35-44)'),
            ('Wavelength', 500., 'emission wavelength in nm'),
            ('FocalLength', '0', "0 = point source, finite = focused beam, "
                                 "'inf' = collimated"),
            ('Divergence', '-', '1/e half-angle, synced with FocalLength'),
            ('ThetaDomain', '0, pi/4', ''),
            ('PhiDomain', '0, 2*pi', ''),
            ('RadiusDomain', '0, 10', ''),
        ]),
        ('OpticalSimulationSettings', [
            ('RandomNumberGeneratorMode', '?', 'readonly compile-mode echo'),
            ('ThetaResolutionNumericMode', '1e5', ''),
            ('RadiusResolutionNumericMode', '1e5', ''),
            ('PhiResolutionNumericMode', '1e2', ''),
            ('Fans', 2, 'number of ray fans in fan mode'),
            ('FanPhi0', '0', 'fan azimuth offset'),
            ('RaysPerFan', 20, ''),
        ]),
    ] + self._baseProperties()

  def __init__(self, placement=None, **kwargs):
    super().__init__(placement=placement, **kwargs)
    self._vrv = None
    self._deviceTables = None

  # ---------------------------------------------------------------- domains

  def parsedThetaDomain(self):
    return parseDomain(self.ThetaDomain, default='0,pi/4',
                       limits=('-20*pi', '20*pi'),
                       spanLimits=(0, '20*pi'))[1]

  def parsedPhiDomain(self):
    return parseDomain(self.PhiDomain, default='0,2*pi',
                       limits=('-20*pi', '20*pi'),
                       spanLimits=(0, '20*pi'))[1]

  def parsedRadiusDomain(self):
    return parseDomain(self.RadiusDomain, default='0,10',
                       limits=(-np.inf, np.inf), spanLimits=(0, np.inf))[1]

  def focalLength(self):
    return evalExpr(self.FocalLength)

  def parsedFanPhi0(self):
    return evalExpr(self.FanPhi0)

  # ------------------------------------------------------ divergence syncing

  def divergence(self):
    '''1/e half-angle of the emission power density, found by root search on
    the theta-only expression (reference: point_source.py:201-236).'''
    f = self.focalLength()
    if not np.isfinite(f):
      return 0.
    expr = sy.sympify(self.PowerDensity).subs(
        'r', sy.sympify(f'(tan(theta)*{abs(f):.8e})'))
    syms = [str(s) for s in expr.free_symbols]
    t1, t2 = self.parsedThetaDomain()
    if np.isclose(f, 0) or syms != ['theta'] or t1 != 0:
      return None
    lam = sy.lambdify('theta', expr)
    maxPower = lam(0)
    try:
      angle = scipy.optimize.bisect(sy.lambdify('theta', expr - maxPower / np.e),
                                    0, t2)
    except Exception:
      io.verb(f'failed to find 1/e angle of {expr} within theta domain '
              f'({t1}, {t2})')
      return None
    return -np.sign(f) * angle

  def setDivergence(self, divergenceAngle):
    '''Update FocalLength so the beam's 1/e angle equals `divergenceAngle`;
    only possible when PowerDensity depends on r alone (reference:
    point_source.py:240-270).'''
    expr = sy.sympify(self.PowerDensity)
    syms = [str(s) for s in expr.free_symbols]
    r1, r2 = self.parsedRadiusDomain()
    if syms != ['r'] or r1 != 0:
      raise ValueError('Divergence is writable only when PowerDensity '
                       'depends on r alone and the radius domain starts at 0')
    lam = sy.lambdify('r', expr)
    maxPower = lam(0)
    oneOverERadius = scipy.optimize.bisect(
        sy.lambdify('r', expr - maxPower / np.e), 0, r2)
    if np.isclose(divergenceAngle, 0):
      self.FocalLength = 'inf'
    else:
      self.FocalLength = f'{-oneOverERadius / np.tan(divergenceAngle):.6g}'
    self.Divergence = f'{divergenceAngle:.6g}'
    self._clearVrv()

  # ----------------------------------------------------- random variable ctor

  def _rvArgs(self, densityString, variableDomain=None, scalarRandomVar=False):
    '''Build the kwargs for the (scalar/vector) random variable from the
    power density string — coordinate substitutions and Jacobians exactly as
    the reference (point_source.py:273-362).'''
    f = self.focalLength()
    if np.isfinite(f):
      if np.isclose(f, 0):
        stripped = densityString
        for fn in ('exp', 'arcsin', 'arccos', 'arctan2', 'arctan', 'arccot',
                   'arsinh', 'arcosh', 'artanh', 'arcoth', 'DiracDelta',
                   'Piecewise', 'Heaviside', 'True', 'False'):
          stripped = stripped.replace(fn, '')
        for c in 'rxy':
          if c in stripped:
            raise ValueError(f'Variable {c} in power density expression '
                             f'{self.PowerDensity} is forbidden if focal '
                             f'length is zero')
      if not scalarRandomVar:
        densityString = '(' + densityString + ')*abs(sin(theta))'
      fAbs = f'{abs(f):.8e}'
      expr = (sy.sympify(densityString)
              .subs('r', sy.sympify(f'(tan(theta)*{fAbs})'))
              .subs('x', sy.sympify(f'(tan(theta)*cos(phi)*{fAbs})'))
              .subs('y', sy.sympify(f'(tan(theta)*sin(phi)*{fAbs})')))
      if scalarRandomVar:
        return dict(probabilityDensity=str(expr), variable='theta',
                    variableDomain=variableDomain,
                    numericalResolution=float(self.ThetaResolutionNumericMode))
      return dict(
          probabilityDensity=str(expr),
          variableOrder=('theta', 'phi'),
          variableDomains=dict(theta=self.parsedThetaDomain(),
                               phi=self.parsedPhiDomain()),
          numericalResolutions=dict(
              theta=float(self.ThetaResolutionNumericMode),
              phi=float(self.PhiResolutionNumericMode)))
    else:
      if 'theta' in densityString:
        raise ValueError(f'Variable theta in power density expression '
                         f'{self.PowerDensity} is forbidden if focal length '
                         f'is infinite.')
      if not scalarRandomVar:
        densityString = '(' + densityString + ')*abs(r)'
      expr = (sy.sympify(densityString)
              .subs('x', sy.sympify('(r*cos(phi))'))
              .subs('y', sy.sympify('(r*sin(phi))')))
      if scalarRandomVar:
        return dict(probabilityDensity=str(expr), variable='r',
                    variableDomain=variableDomain,
                    numericalResolution=float(self.RadiusResolutionNumericMode))
      return dict(
          probabilityDensity=str(expr),
          variableOrder=('r', 'phi'),
          variableDomains=dict(r=self.parsedRadiusDomain(),
                               phi=self.parsedPhiDomain()),
          numericalResolutions=dict(
              r=float(self.RadiusResolutionNumericMode),
              phi=float(self.PhiResolutionNumericMode)))

  def _getVrv(self):
    if self._vrv is None:
      self._vrv = distributions.VectorRandomVariable(
          **self._rvArgs(self.PowerDensity))
      self._vrv.compile()
      self.RandomNumberGeneratorMode = self._vrv.mode()
    return self._vrv

  def _clearVrv(self):
    self._vrv = None
    self._deviceTables = None
    self.RandomNumberGeneratorMode = '?'

  # --------------------------------------------------------------- ray maths

  def _localRay(self, thetaOrRadius, phi):
    '''Local-frame (origin, direction) of one ray (reference:
    point_source.py:407-447). With finite focal length all rays pass through
    (0,0,f); with infinite focal length rays run parallel to +z.'''
    f = self.focalLength()
    if np.isfinite(f):
      theta = thetaOrRadius
      st, ct = np.sin(theta), np.cos(theta)
      d = np.array([st * np.sin(phi), -st * np.cos(phi), ct])
      o = (np.array([0., 0., 1.]) - d) * f
      radius = np.tan(theta) * f
    else:
      radius = thetaOrRadius
      theta = np.nan
      d = np.array([0., 0., 1.])
      o = np.array([radius * np.cos(phi), -radius * np.sin(phi), 0.])
    return o, d, theta, radius

  def makeRaysHost(self, thetasOrRadii, phis):
    '''Vectorized world-frame ray batch from sampled coordinates (host).'''
    t = np.asarray(thetasOrRadii, dtype=float)
    p = np.asarray(phis, dtype=float)
    f = self.focalLength()
    if np.isfinite(f):
      st, ct = np.sin(t), np.cos(t)
      d = np.stack([st * np.sin(p), -st * np.cos(p), ct], axis=-1)
      o = (np.array([0., 0., 1.]) - d) * f
      theta, radius = t, np.tan(t) * f
    else:
      d = np.broadcast_to(np.array([0., 0., 1.]), (len(t), 3)).copy()
      o = np.stack([t * np.cos(p), -t * np.sin(p), np.zeros_like(t)], axis=-1)
      theta, radius = np.full_like(t, np.nan), t
    R, off = self.placement[:3, :3], self.placement[:3, 3]
    origins = o @ R.T + off
    directions = d @ R.T
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    return dict(origins=origins, directions=directions,
                powers=np.ones(len(t)),
                wavelengths=np.full(len(t), float(self.Wavelength)),
                metadata=dict(initPhi=p, initTheta=theta, initRadius=radius))

  # -------------------------------------------------------------- generation

  def generateRays(self, mode, settings=None, maxFanCount=np.inf,
                   maxRaysPerFan=np.inf, rng=None):
    '''Host-side ray batch for one iteration; mode in
    {'fans', 'true', 'pseudo'} (reference: point_source.py:459-657).'''
    if mode == 'fans':
      return self._generateFans(maxFanCount, maxRaysPerFan)
    if mode in ('true', 'pseudo'):
      raysPerIteration = 100
      if settings is not None:
        raysPerIteration = settings.raysPerIteration()
      raysPerIteration = max(1, int(round(
          raysPerIteration * float(self.RaysPerIterationScale))))
      vrv = self._getVrv()
      if mode == 'true':
        tp = vrv.draw(N=raysPerIteration, rng=rng)
      else:
        tp = vrv.drawPseudo(N=raysPerIteration, rng=rng)
      return self.makeRaysHost(tp[0], tp[1])
    raise ValueError(f'unexpected ray placement mode {mode}')

  def _generateFans(self, maxFanCount, maxRaysPerFan):
    '''Deterministic ray fans (reference: point_source.py:469-634).'''
    raysPerFan = int(min(self.RaysPerFan, maxRaysPerFan))
    totalFanCount = int(min(self.Fans, maxFanCount))
    f = self.focalLength()
    if np.isfinite(f):
      l1, l2 = self.parsedThetaDomain()
    else:
      l1, l2 = self.parsedRadiusDomain()
    phiL1, phiL2 = self.parsedPhiDomain()

    if (l1 > 0 and l2 > 0) or (l1 < 0 and l2 < 0):
      fanMode = 'gapped'
      raysPerFan = max(4, int(np.ceil(raysPerFan / 2) * 2))
    elif l1 == 0 or l2 == 0:
      fanMode = 'stitched'
    elif l1 < 0 and l2 > 0:
      fanMode = 'theta-sign-change'
    else:
      raise ValueError(f'{l1=}, {l2=}')
    io.verb(f'using fan generation mode "{fanMode}"')

    allT, allPhi, meta = [], [], dict(fanIndex=[], rayIndex=[],
                                      totalFanCount=[], totalRaysInFan=[])
    for fanIndex, basePhi in enumerate(
        self.parsedFanPhi0() + np.linspace(0, np.pi, totalFanCount + 1)[:-1]):
      cands = [phi for phi in np.arange(basePhi - 30 * np.pi,
                                        basePhi + 31 * np.pi, np.pi)
               if phiL1 - 1e-9 <= phi <= phiL2 + 1e-9]
      if not cands:
        io.verb(f'skipping fan {fanIndex}: no suitable phi in phi domain')
        continue
      phiA = cands[int(np.argmin(np.abs(basePhi - np.array(cands))))]
      cands = [phi for phi in np.arange(phiA + np.pi - 30 * np.pi,
                                        phiA + np.pi + 31 * np.pi, 2 * np.pi)
               if phiL1 - 1e-9 <= phi <= phiL2 + 1e-9]
      phiB = (np.nan if not cands else
              cands[int(np.argmin(np.abs(phiA + np.pi - np.array(cands))))])

      if fanMode == 'gapped':
        srv = distributions.ScalarRandomVariable(
            **self._rvArgs(self.PowerDensity, variableDomain=(l1, l2),
                           scalarRandomVar=True))
        srv.compile(phi=phiA)
        side1 = srv.findGrid(N=raysPerFan // 2)
        srv.compile(phi=phiB)
        side2 = srv.findGrid(N=raysPerFan // 2)
      elif fanMode == 'stitched':
        limit = max(abs(l1), abs(l2))
        var = 'theta' if np.isfinite(f) else 'r'
        base = (sy.sympify(self.PowerDensity)
                .subs('theta', 'abs(theta)').subs('r', 'abs(r)'))
        if np.isfinite(phiB):
          dens = str(base.subs('phi', sy.sympify(
              f'Piecewise( ( ({phiA}), ({var})>0 ), ( ({phiB}), True ) )')))
          domain = (-limit, limit)
        else:
          dens = str(base)
          domain = (0, limit)
        srv = distributions.ScalarRandomVariable(
            **self._rvArgs(dens, variableDomain=domain, scalarRandomVar=True))
        srv.compile(phi=phiA)
        side1, side2 = srv.findGrid(N=raysPerFan), []
      elif fanMode == 'theta-sign-change':
        srv = distributions.ScalarRandomVariable(
            **self._rvArgs(self.PowerDensity, variableDomain=(l1, l2),
                           scalarRandomVar=True))
        srv.compile(phi=phiA)
        side1, side2 = srv.findGrid(N=raysPerFan), []

      if len(side2) > 0:
        side1 = sorted(side1, key=abs)
        side2 = sorted(side2, key=abs)
        idx1 = list(1 + np.arange(len(side1)))
        idx2 = list(-(1 + np.arange(len(side2))))
      else:
        side1 = np.array(sorted(side1))
        i0 = int(np.argmin(np.abs(side1)))
        idx1 = list(np.arange(len(side1)) - i0)
        idx2 = []

      packed = (list(zip(idx1, side1, [phiA] * len(side1)))
                + list(zip(idx2, side2, [phiB] * len(side2))))
      for rayIndex, val, phi in sorted(packed, key=lambda e: abs(e[0]) - .1):
        allT.append(val)
        allPhi.append(phi)
        meta['fanIndex'].append(int(fanIndex))
        meta['rayIndex'].append(int(rayIndex))
        meta['totalFanCount'].append(int(totalFanCount))
        meta['totalRaysInFan'].append(len(packed))

    batch = self.makeRaysHost(np.array(allT), np.array(allPhi))
    batch['metadata'].update({k: np.array(v) for k, v in meta.items()})
    return batch

  # ------------------------------------------------------------- device path

  def supportsDeviceSampling(self):
    return True

  def deviceGenerator(self):
    '''Return a jittable `generate(key, N, stratified=False)` producing the
    full ray batch on device — sampling through the compiled inverse-CDF
    tables and applying the ray-placement math in jnp.'''
    if self._deviceTables is None:
      self._deviceTables = buildDeviceTables(self._getVrv())
    tables = self._deviceTables
    f = self.focalLength()
    finite = bool(np.isfinite(f))
    # placement rotation applied as component FMAs with host-scalar R
    # entries, not as `@ R.T`: an f32 matmul may run at reduced input
    # precision (TF32 on a GPU) unless asked otherwise, while the FMAs
    # are exact f32 on every backend
    R = np.asarray(self.placement[:3, :3], dtype=float)
    off = np.asarray(self.placement[:3, 3], dtype=float)
    wavelength = float(self.Wavelength)

    # f=inf: the beam direction is CONSTANT — rotate it host-side once
    beamDir = jnp.asarray(R @ np.array([0., 0., 1.]), jnp.float32)

    def generate(key, N, stratified=False):
      tp = deviceDraw(tables, key, N, stratified=stratified)
      t, p = tp[0], tp[1]
      if finite:
        st, ct = jnp.sin(t), jnp.cos(t)
        ldx, ldy, ldz = st * jnp.sin(p), -st * jnp.cos(p), ct
        lox, loy, loz = -f * ldx, -f * ldy, f * (1. - ldz)
        theta, radius = t, jnp.tan(t) * f
        directions = jnp.stack(
            [R[0, 0] * ldx + R[0, 1] * ldy + R[0, 2] * ldz,
             R[1, 0] * ldx + R[1, 1] * ldy + R[1, 2] * ldz,
             R[2, 0] * ldx + R[2, 1] * ldy + R[2, 2] * ldz], axis=-1)
      else:
        lox, loy = t * jnp.cos(p), -t * jnp.sin(p)
        loz = jnp.zeros_like(t)
        theta, radius = jnp.full_like(t, jnp.nan), t
        directions = jnp.broadcast_to(beamDir, (N, 3))
      origins = jnp.stack(
          [R[0, 0] * lox + R[0, 1] * loy + R[0, 2] * loz + off[0],
           R[1, 0] * lox + R[1, 1] * loy + R[1, 2] * loz + off[1],
           R[2, 0] * lox + R[2, 1] * loy + R[2, 2] * loz + off[2]],
          axis=-1)
      return dict(origins=origins.astype(jnp.float32),
                  directions=directions.astype(jnp.float32),
                  powers=jnp.ones((N,), jnp.float32),
                  wavelengths=jnp.full((N,), wavelength, jnp.float32),
                  metadata=dict(initPhi=p, initTheta=theta,
                                initRadius=radius))

    return generate

  def deviceGeomGenerator(self):
    '''Geometry-parameterized device generator for the batched sweep
    (jupyter_utils/parameter_sweeper.evaluateBatched): returns
    `generate(geom, key, N)` where `geom` is a TRACED (13,) array
    [R row-major (9), offset (3), wavelength] — so one jitted sweep step
    can trace many variants that differ only in source placement /
    wavelength without re-tracing per variant. The inverse-CDF tables and
    the focal length stay closure constants (they parameterize the SAMPLING
    math, not the placement); callers must ensure they are identical across
    variants (parameter_sweeper._sourceSignatures).'''
    if self._deviceTables is None:
      self._deviceTables = buildDeviceTables(self._getVrv())
    tables = self._deviceTables
    f = self.focalLength()
    finite = bool(np.isfinite(f))

    def generate(geom, key, N):
      R = geom[:9]
      off = geom[9:12]
      wavelength = geom[12]
      tp = deviceDraw(tables, key, N)
      t, p = tp[0], tp[1]
      if finite:
        st, ct = jnp.sin(t), jnp.cos(t)
        ldx, ldy, ldz = st * jnp.sin(p), -st * jnp.cos(p), ct
        lox, loy, loz = -f * ldx, -f * ldy, f * (1. - ldz)
      else:
        lox, loy = t * jnp.cos(p), -t * jnp.sin(p)
        loz = jnp.zeros_like(t)
        ldx, ldy = jnp.zeros_like(t), jnp.zeros_like(t)
        ldz = jnp.ones_like(t)
      # component FMAs (not `@ R.T`): exact f32 on every backend (see
      # deviceGenerator above)
      origins = jnp.stack(
          [R[0] * lox + R[1] * loy + R[2] * loz + off[0],
           R[3] * lox + R[4] * loy + R[5] * loz + off[1],
           R[6] * lox + R[7] * loy + R[8] * loz + off[2]], axis=-1)
      directions = jnp.stack(
          [R[0] * ldx + R[1] * ldy + R[2] * ldz,
           R[3] * ldx + R[4] * ldy + R[5] * ldz,
           R[6] * ldx + R[7] * ldy + R[8] * ldz], axis=-1)
      return dict(origins=origins.astype(jnp.float32),
                  directions=directions.astype(jnp.float32),
                  powers=jnp.ones((N,), jnp.float32),
                  wavelengths=jnp.full((N,), wavelength, jnp.float32))

    return generate
