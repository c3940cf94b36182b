'''
Batched column-SoA bounce step — the device path.

Physics-identical to tracer.bounceOne (the per-ray reference
implementation, kept for clarity and as the test oracle), but written for
wide batches:

  * ray state lives in (N,) component columns, never (N, 3) / (N, 3, 3)
    tensors with tiny minor dimensions,
  * all per-hit surface data arrives via ONE packed-row gather
    (surfaces['packed'][idx] -> (N, K)), element data via one more,
  * rigid transforms apply as column dot products; l2w rotation is the
    transpose of the packed w2l rotation (placements are rigid).
'''

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..distributions.device_sampler import (
    evalPwpoly as _evalPwpoly, evalPwpoly2d as _evalPwpoly2d,
    evalDiscreteEvents as _evalDiscreteEvents)
from ..geometry import intersect as I
from ..geometry import surfaces as S
from ..geometry.surfaces import (PACKED_ROT, PACKED_OFF, PACKED_ORIENT,
                                 PACKED_ELEM, PACKED_KIND, PACKED_PARAMS)
from .element_table import (EP_OPTTYPE, EP_REFRINDEX, EP_REFLECTIVITY,
                            EP_ABSLENGTH, EP_GRATTYPE, EP_GRATLPM,
                            EP_GRATDIRX, EP_GRATDIRY, EP_GRATDIRZ,
                            EP_GRATORDER, EP_RECORDHITS)
from .tracer import (MIRROR, LENS, GRATING, ABSORBER, VACUUM, VACUUM_MEDIUM,
                     GRATING_REFLECTION)


def _dot3(ax, ay, az, bx, by, bz):
  return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
  return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _norm3(ax, ay, az, eps=1e-20):
  inv = lax.rsqrt(ax * ax + ay * ay + az * az + eps)
  return ax * inv, ay * inv, az * inv


def allDistancesBatch(table, ox, oy, oz, dx, dy, dz, tMin, seqAllowed=None):
  '''(N, S) distance matrix, surface-major per-kind sweep: per surface the
  world->local transform is applied as broadcast scalars (no per-ray
  transform gathers at all).'''
  parts = []
  for kindName in sorted(table['byKind'], key=S.KIND_CODES.get):
    sub = table['byKind'][kindName]
    fn = S.KIND_INTERSECTORS[kindName]

    def oneSurface(params, trim, rot, off, mask=None, prims=None):
      lox = rot[0, 0] * ox + rot[0, 1] * oy + rot[0, 2] * oz + off[0]
      loy = rot[1, 0] * ox + rot[1, 1] * oy + rot[1, 2] * oz + off[1]
      loz = rot[2, 0] * ox + rot[2, 1] * oy + rot[2, 2] * oz + off[2]
      ldx = rot[0, 0] * dx + rot[0, 1] * dy + rot[0, 2] * dz
      ldy = rot[1, 0] * dx + rot[1, 1] * dy + rot[1, 2] * dz
      ldz = rot[2, 0] * dx + rot[2, 1] * dy + rot[2, 2] * dz
      lo = jnp.stack([lox, loy, loz], axis=-1)
      ld = jnp.stack([ldx, ldy, ldz], axis=-1)
      return jax.vmap(lambda o, d: fn(params, trim, o, d, tMin,
                                      mask=mask, prims=prims))(lo, ld)

    # vmap over the surfaces of this kind -> (S_k, N); bitmap masks and
    # hole-primitive rows ride as extra vmapped operands when present
    haveMask = 'trimMaskIdx' in sub
    havePrims = 'trimPrims' in sub
    masks = table['trimMasks'] if haveMask else None
    args = [sub['params'], sub['trim'], sub['w2lRot'], sub['w2lOff']]
    if haveMask and havePrims:
      parts.append(jax.vmap(
          lambda p, t, r, o, mi, pr: oneSurface(p, t, r, o, masks[mi], pr))(
          *args, sub['trimMaskIdx'], sub['trimPrims']))
    elif haveMask:
      parts.append(jax.vmap(
          lambda p, t, r, o, mi: oneSurface(p, t, r, o, masks[mi]))(
          *args, sub['trimMaskIdx']))
    elif havePrims:
      parts.append(jax.vmap(
          lambda p, t, r, o, pr: oneSurface(p, t, r, o, prims=pr))(
          *args, sub['trimPrims']))
    else:
      parts.append(jax.vmap(
          lambda p, t, r, o: oneSurface(p, t, r, o))(*args))
  t = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
  if seqAllowed is not None:
    # seqAllowed is (S, N) or (S, 1), matching t's (S, N) layout here
    t = jnp.where(seqAllowed, t, jnp.inf)
  return t  # (S, N): surfaces on the MAJOR axis so reductions run over
            # full 128-lane rows (a (N, S) layout with tiny minor dim costs
            # ~140 ms per argmin at N=1e6)


def selectNearestBatch(t, elem, medium, distTol, maxRayLength):
  '''Batched reference tie-breaking (ray.py:388-401) on a (S, N) distance
  matrix. Returns (idx (N,), tHit (N,), hasHit (N,)).'''
  t = jnp.where(t <= maxRayLength, t, jnp.inf)
  tMin = jnp.min(t, axis=0)
  valid = jnp.isfinite(t)
  prefer = valid & (t <= tMin[None, :] + 2 * distTol) \
      & (elem[:, None] != medium[None, :])
  hasPrefer = jnp.any(prefer, axis=0)
  tPref = jnp.where(prefer, t, jnp.inf)
  idx = jnp.where(hasPrefer, jnp.argmin(tPref, axis=0),
                  jnp.argmin(t, axis=0))
  hasHit = jnp.isfinite(tMin)
  tHit = jnp.where(hasPrefer, jnp.min(tPref, axis=0), tMin)
  return idx, jnp.where(hasHit, tHit, jnp.inf), hasHit


def _localNormal(kindf, prm, plx, ply, plz):
  '''Canonical local normal, selected per kind via where-chains on column
  arrays (mirrors surfaces.normalLocal).'''
  # sphere
  sx, sy, sz = _norm3(plx, ply, plz)
  # cylinder
  cx, cy, _ = _norm3(plx, ply, jnp.zeros_like(plz))
  # asphere
  r2 = plx * plx + ply * ply
  c, k = prm[:, 0], prm[:, 1]
  a4, a6, a8 = prm[:, 2], prm[:, 3], prm[:, 4]
  root = jnp.sqrt(jnp.maximum(1 - (1 + k) * c * c * r2, 1e-12))
  g = (c * (2 / (1 + root) + (1 + k) * c * c * r2 / (root * (1 + root) ** 2))
       + 4 * a4 * r2 + 6 * a6 * r2 * r2 + 8 * a8 * r2 ** 3)
  ax, ay, az = _norm3(-g * plx, -g * ply, jnp.ones_like(plz))
  # triangle
  e1x, e1y, e1z = prm[:, 3] - prm[:, 0], prm[:, 4] - prm[:, 1], prm[:, 5] - prm[:, 2]
  e2x, e2y, e2z = prm[:, 6] - prm[:, 0], prm[:, 7] - prm[:, 1], prm[:, 8] - prm[:, 2]
  tx, ty, tz = _norm3(*_cross3(e1x, e1y, e1z, e2x, e2y, e2z))

  # cone: radial out, tipped by -tanAngle along z (params[:, 1])
  r = jnp.sqrt(r2)
  rSafe = jnp.where(r < 1e-12, 1e-12, r)
  kx, ky, kz = _norm3(plx / rSafe, ply / rSafe,
                      -prm[:, 1] * jnp.ones_like(plz))

  # quadric: grad f = (2 qa x, 2 qb y, 2 qc z + qz)
  qx, qy, qz = _norm3(2 * prm[:, 0] * plx, 2 * prm[:, 1] * ply,
                      2 * prm[:, 2] * plz + prm[:, 3])

  # torus: (p - tube-circle center) / r (surfaces.normalLocal nTorus)
  toScale = prm[:, 0] / rSafe
  ox_, oy_, oz_ = _norm3(plx * (1. - toScale), ply * (1. - toScale), plz)

  isS = kindf == S.SPHERE
  isC = kindf == S.CYLINDER
  isA = kindf == S.ASPHERE
  isT = kindf == S.TRIANGLE
  isK = kindf == S.CONE
  isQ = kindf == S.QUADRIC
  isO = kindf == S.TORUS
  nx = jnp.where(isS, sx, jnp.where(isC, cx, jnp.where(isA, ax,
                 jnp.where(isT, tx, jnp.where(isK, kx,
                 jnp.where(isQ, qx, jnp.where(isO, ox_, 0.)))))))
  ny = jnp.where(isS, sy, jnp.where(isC, cy, jnp.where(isA, ay,
                 jnp.where(isT, ty, jnp.where(isK, ky,
                 jnp.where(isQ, qy, jnp.where(isO, oy_, 0.)))))))
  nz = jnp.where(isS, sz, jnp.where(isC, 0., jnp.where(isA, az,
                 jnp.where(isT, tz, jnp.where(isK, kz,
                 jnp.where(isQ, qz, jnp.where(isO, oz_, 1.)))))))
  return nx, ny, nz


def sceneStaticFlags(scene):
  '''Host-side inspection of a CONCRETE scene: which interaction formulas
  can be skipped entirely at compile time (callable only outside jit or on
  closure-captured scenes).'''
  opt = np.asarray(scene['elements']['optType'])
  return dict(hasMirror=bool((opt == MIRROR).any()),
              hasLens=bool((opt == LENS).any()),
              hasGrating=bool((opt == GRATING).any()))


def _rot3(vx, vy, vz, ax, ay, az, angle):
  '''Rodrigues rotation of column vectors v about unit axes a.'''
  c, s = jnp.cos(angle), jnp.sin(angle)
  cx, cy, cz = _cross3(ax, ay, az, vx, vy, vz)
  dot = ax * vx + ay * vy + az * vz
  return (vx * c + cx * s + ax * dot * (1 - c),
          vy * c + cy * s + ay * dot * (1 - c),
          vz * c + cz * s + az * dot * (1 - c))


def scatterConstants(scene):
  '''Host-side compile-time representation of the scatter tables as
  piecewise Horner polynomials. Covers, per flagged (element, kind):
  - phi-separable continuous marginals (theta rows equal across the M phi
    bins — true for every separable density f(theta) g(phi)), either
    incidence-INDEPENDENT (one 1-D pwpoly) or theta_in-CONDITIONED (a
    bivariate pwpoly2d in (quantile, theta_in) — e.g. a lobe that narrows
    with grazing incidence, or any density mentioning theta_in);
  - discrete DiracDelta events whose values/probabilities vary smoothly
    with theta_in (e.g. DiracDelta(theta - theta_refl) ideal-behavior
    mixtures, reference optical_group.py:40-58), fitted as 1-D
    polynomials over the incidence angle.
  Returns a hashable nested tuple of entries
  (e, k, phiSpec, thetaSpec, phiDisc, thetaDisc) (rides the jit static
  args next to sceneStaticFlags) or None — callers then keep the exact
  gather-based _scatterDraw. The fits replace random gathers by unrolled
  masked polynomials (whether that pays on a GPU is not measured yet).
  Conditioned/Dirac draws evaluate the fits at the CONTINUOUS incidence
  angle where the gather path quantizes to
  the nearest of the Tin grid rows — statistically equivalent, tested in
  tests/test_scatter.py.'''
  if 'scatter' not in scene:
    return None
  sc = scene['scatter']
  try:
    if isinstance(sc['phiInv'], jax.core.Tracer):
      return None
    flags = np.asarray(sc['flags'])
    phiInv = np.asarray(sc['phiInv'], dtype=float)
    thetaInv = np.asarray(sc['thetaInv'], dtype=float)
    disc = None
    if 'thetaDiscVals' in sc:
      disc = {n: np.asarray(sc[n], dtype=float) for n in
              ('thetaDiscVals', 'thetaDiscCum',
               'phiDiscVals', 'phiDiscCum')}
  except Exception:
    return None
  from ..distributions.device_sampler import (fitPiecewisePoly,
                                              fitPiecewisePoly2d, fitPoly1d)
  E, K, Tin, Q = phiInv.shape
  grid = np.linspace(0., np.pi / 2, Tin)   # models/scatter.py thetaInGrid
  combos = [(e, k) for e in range(E) for k in range(K) if flags[e, k]]
  if not combos or len(combos) > 16:
    return None

  def fitMarginal(rows):                      # (Tin, Q)
    tol = 1e-6 * max(np.ptp(rows), 1e-30)
    if np.allclose(rows, rows[0:1, :], atol=tol):
      # incidence-independent (every theta-only density): ONE polynomial.
      # A per-Tin-row unroll is a trap: 33 rows x 2 draws of masked
      # polynomials defeat XLA fusion and run SLOWER than the gathers
      # they replace (measured 208 ms vs 116 ms per 1M-ray step).
      return fitPiecewisePoly(rows[0])
    return fitPiecewisePoly2d(rows, grid)

  def fitDisc(cum, vals):                     # (Tin, D) each
    if cum.size == 0 or not cum.any():
      return ()
    events = []
    for d in range(cum.shape[1]):
      if d and np.allclose(cum[:, d], cum[:, d - 1]):
        continue        # forward-fill padding column (models/scatter.pad)
      # cumulative probabilities live in [0,1] and only gate branch
      # selection — an absolute ~2e-4 fit error misroutes O(0.02%) of
      # draws, far below MC noise at any realistic ray count, so the
      # tolerance is effectively absolute (1e-3 of the <=1 range floor)
      # where event VALUES (angles) keep the tight default
      cs = fitPoly1d(cum[:, d], grid, deg=12, relTol=1e-3)
      vs = fitPoly1d(vals[:, d], grid)
      if cs is None or vs is None:
        return None     # kinked over theta_in (e.g. TIR onset) -> gather
      events.append((cs, vs))
    return tuple(events)

  out = []
  for e, k in combos:
    rowsT = thetaInv[e, k]                    # (Tin, M, Q)
    tolT = 1e-6 * max(np.ptp(rowsT), 1e-30)
    if not np.allclose(rowsT, rowsT[:, 0:1, :], atol=tolT):
      # theta|phi coupling (e.g. astigmatic scatter): low-rank separable
      # expansion over the phi axis (device_sampler.fitLowRankTheta);
      # fits that miss tolerance keep the exact gather path
      from ..distributions.device_sampler import fitLowRankTheta
      M = rowsT.shape[1]
      phiGrid = (float(sc['phiGridLo'])
                 + float(sc['phiGridStep']) * np.arange(M))
      tf = fitLowRankTheta(rowsT, grid, phiGrid)
    else:
      tf = fitMarginal(rowsT[:, 0, :])
    pf = fitMarginal(phiInv[e, k])
    if tf is None or pf is None:
      return None
    tDisc = pDisc = ()
    if disc is not None:
      tDisc = fitDisc(disc['thetaDiscCum'][e, k],
                      disc['thetaDiscVals'][e, k])
      pDisc = fitDisc(disc['phiDiscCum'][e, k],
                      disc['phiDiscVals'][e, k])
      if tDisc is None or pDisc is None:
        return None
    out.append((e, k, pf, tf, pDisc, tDisc))
  return tuple(out)


def _evalMarginalConst(spec, u, thetaIn, phi=None):
  if spec[0] == 'pwpoly2d':
    return _evalPwpoly2d(spec, u, thetaIn)
  if spec[0] == 'lowrank':
    # theta|phi-coupled family: conditioned on BOTH the incidence angle
    # and the already-drawn phi (device_sampler.fitLowRankTheta)
    from ..distributions.device_sampler import evalLowRankTheta
    return evalLowRankTheta(spec, u, thetaIn, phi)
  return _evalPwpoly(spec, u)


def _scatterDrawConst(consts, elemIdx, kind, thetaIn, u1, u2, u3, u4):
  '''Gather-free twin of _scatterDraw for compile-time scatter constants
  (phi-separable lobes, theta_in-conditioned fits evaluated at the
  continuous incidence angle, discrete Dirac events via u3/u4 — see
  scatterConstants).'''
  phiOut = jnp.zeros_like(u1)
  thetaOut = jnp.zeros_like(u2)
  for e, k, phiSpec, thetaSpec, phiDisc, thetaDisc in consts:
    m = (elemIdx == e) & (kind == k)
    ph = _evalMarginalConst(phiSpec, u1, thetaIn)
    ph = _evalDiscreteEvents(phiDisc, thetaIn, u3, ph)
    # theta conditions on the drawn phi AFTER its discrete overwrite,
    # matching the exact gather path (_scatterDraw phiIdx from phiOut)
    th = _evalMarginalConst(thetaSpec, u2, thetaIn, ph)
    th = _evalDiscreteEvents(thetaDisc, thetaIn, u4, th)
    phiOut = jnp.where(m, ph, phiOut)
    thetaOut = jnp.where(m, th, thetaOut)
  return thetaOut, phiOut


def _scatterDraw(sc, elemIdx, kind, tinIdx, u1, u2, u3, u4):
  '''Draw (thetaOut, phiOut) from the stacked conditional scatter tables
  (see models/scatter.py for the layout). phi is drawn from its marginal,
  theta conditioned on the drawn phi.'''
  phiInv = sc['phiInv']        # (E, K, Tin, Q)
  thetaInv = sc['thetaInv']    # (E, K, Tin, M, Q)
  E, K, Tin, Q = phiInv.shape
  M = thetaInv.shape[3]
  base = (elemIdx * K + kind) * Tin + tinIdx

  pos = u1 * (Q - 1)
  j = jnp.clip(pos.astype(jnp.int32), 0, Q - 2)
  frac = pos - j
  # ONE 2-wide pair gather instead of two scalar gathers
  pairP = sc['phiInvPairs'][base * (Q - 1) + j]
  phiOut = pairP[:, 0] + frac * (pairP[:, 1] - pairP[:, 0])
  if 'phiDiscVals' in sc:
    D = sc['phiDiscVals'].shape[-1]
    cumF = sc['phiDiscCum'].reshape(-1, D)[base]
    valF = sc['phiDiscVals'].reshape(-1, D)[base]
    dIdx = jnp.clip(jnp.sum((u3[:, None] > cumF).astype(jnp.int32), axis=1),
                    0, D - 1)
    lastCum = cumF[:, D - 1]
    phiOut = jnp.where(u3 <= lastCum,
                       jnp.take_along_axis(valF, dIdx[:, None], 1)[:, 0],
                       phiOut)

  phiIdx = jnp.clip(jnp.round(
      (phiOut - sc['phiGridLo']) / sc['phiGridStep']).astype(jnp.int32),
      0, M - 1)
  pos2 = u2 * (Q - 1)
  j2 = jnp.clip(pos2.astype(jnp.int32), 0, Q - 2)
  frac2 = pos2 - j2
  pairT = sc['thetaInvPairs'][(base * M + phiIdx) * (Q - 1) + j2]
  thetaOut = pairT[:, 0] + frac2 * (pairT[:, 1] - pairT[:, 0])
  if 'thetaDiscVals' in sc:
    D = sc['thetaDiscVals'].shape[-1]
    cumF = sc['thetaDiscCum'].reshape(-1, D)[base]
    valF = sc['thetaDiscVals'].reshape(-1, D)[base]
    dIdx = jnp.clip(jnp.sum((u4[:, None] > cumF).astype(jnp.int32), axis=1),
                    0, D - 1)
    lastCum = cumF[:, D - 1]
    thetaOut = jnp.where(u4 <= lastCum,
                         jnp.take_along_axis(valF, dIdx[:, None], 1)[:, 0],
                         thetaOut)
  return thetaOut, phiOut


def bounceBatch(scene, distTol, maxRayLength, o, d, power, wl, medium, seq,
                alive, staticFlags=None, key=None):
  '''One bounce for the whole batch. Same signature/semantics as
  vmap(bounceOne) but column-SoA inside; returns (newState, records) with
  records carrying column fields plus local hit coordinates (plx, ply) for
  free histogram binning. `staticFlags` (from sceneStaticFlags) lets the
  compiler drop interaction formulas for element types absent from the
  scene.'''
  flags = staticFlags or dict(hasMirror=True, hasLens=True, hasGrating=True)
  surf = scene['surfaces']
  elements = scene['elements']
  N = o.shape[0]
  ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
  dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

  seqMask = scene.get('seqMask', None)
  seqAllowed = scene.get('surfMask', None)
  if seqAllowed is not None:
    seqAllowed = jnp.broadcast_to(seqAllowed[:, None],
                                  (seqAllowed.shape[0], N))
  if seqMask is not None:
    q = jnp.clip(seq, 0, seqMask.shape[0] - 1)
    allowed = seqMask[q].T  # (S, N)
    seqAllowed = allowed if seqAllowed is None else (allowed & seqAllowed)

  t = allDistancesBatch(surf, ox, oy, oz, dx, dy, dz, distTol, seqAllowed)
  idx, tHit, hasHit = selectNearestBatch(t, surf['elem'], medium, distTol,
                                         maxRayLength)
  tSeg = jnp.where(hasHit, tHit, maxRayLength)
  px, py, pz = ox + tSeg * dx, oy + tSeg * dy, oz + tSeg * dz

  # ---- one packed gather per table ----
  sp = surf['packed'][idx]                      # (N, Ks)
  r = [sp[:, PACKED_ROT + i] for i in range(9)]
  offx, offy, offz = (sp[:, PACKED_OFF], sp[:, PACKED_OFF + 1],
                      sp[:, PACKED_OFF + 2])
  orient = sp[:, PACKED_ORIENT]
  elemIdx = sp[:, PACKED_ELEM].astype(jnp.int32)
  kindf = sp[:, PACKED_KIND].astype(jnp.int32)
  prm = sp[:, PACKED_PARAMS:PACKED_PARAMS + 9]

  ep = elements['packed'][elemIdx]              # (N, Ke)
  # one gather for the current-medium element row too (used by n and
  # Beer-Lambert); two separate single-column gathers cost ~78 ms each
  epMed = elements['packed'][jnp.maximum(medium, 0)]
  optType = ep[:, EP_OPTTYPE].astype(jnp.int32)
  reflectivity = ep[:, EP_REFLECTIVITY]
  absLen = ep[:, EP_ABSLENGTH]
  gratType = ep[:, EP_GRATTYPE].astype(jnp.int32)
  gratLpm = ep[:, EP_GRATLPM]
  gDirX, gDirY, gDirZ = (ep[:, EP_GRATDIRX], ep[:, EP_GRATDIRY],
                         ep[:, EP_GRATDIRZ])
  gratOrder = ep[:, EP_GRATORDER]
  recordHits = ep[:, EP_RECORDHITS] > 0.5

  # refractive index (dispersion-aware)
  if 'nTable' in elements:
    disp = jax.vmap(lambda row, w: jnp.interp(w, elements['nLambda'], row))(
        elements['nTable'][elemIdx], wl)
    hasDisp = elements['hasDispersion'][elemIdx]
    nElem = jnp.where(hasDisp, disp, ep[:, EP_REFRINDEX])
    nMedRaw = jax.vmap(lambda row, w: jnp.interp(w, elements['nLambda'], row))(
        elements['nTable'][jnp.maximum(medium, 0)], wl)
    hasDispM = elements['hasDispersion'][jnp.maximum(medium, 0)]
    nMedium = jnp.where(medium >= 0,
                        jnp.where(hasDispM, nMedRaw,
                                  epMed[:, EP_REFRINDEX]), 1.)
  else:
    nElem = ep[:, EP_REFRINDEX]
    nMedium = jnp.where(medium >= 0, epMed[:, EP_REFRINDEX], 1.)

  # ---- local hit point & normal ----
  plx = r[0] * px + r[1] * py + r[2] * pz + offx
  ply = r[3] * px + r[4] * py + r[5] * pz + offy
  plz = r[6] * px + r[7] * py + r[8] * pz + offz
  nlx, nly, nlz = _localNormal(kindf, prm, plx, ply, plz)
  # world normal via transpose (rigid transform)
  nwx = r[0] * nlx + r[3] * nly + r[6] * nlz
  nwy = r[1] * nlx + r[4] * nly + r[7] * nlz
  nwz = r[2] * nlx + r[5] * nly + r[8] * nlz
  outx, outy, outz = nwx * orient, nwy * orient, nwz * orient
  cosA = _dot3(dx, dy, dz, outx, outy, outz)
  isEntering = cosA < 0
  sgn = jnp.where(isEntering, -1., 1.)
  nx, ny, nz = outx * sgn, outy * sgn, outz * sgn   # forward normal

  powerBefore = power
  # Beer-Lambert (multiplicative; see tracer module docstring)
  inMedium = medium >= 0
  absLenMed = jnp.where(inMedium, epMed[:, EP_ABSLENGTH], jnp.inf)
  factor = jnp.where(absLenMed == 0, 0.,
                     jnp.where(jnp.isfinite(absLenMed),
                               jnp.exp(-tSeg / jnp.maximum(absLenMed, 1e-30)),
                               1.))
  power = jnp.where(inMedium, power * factor, power)

  # ---- interactions ----
  dDotN = _dot3(dx, dy, dz, nx, ny, nz)
  mx, my, mz = dx - 2 * nx * dDotN, dy - 2 * ny * dDotN, dz - 2 * nz * dDotN

  # Snell (n forward): mu = n1/n2
  n1 = nMedium
  n2 = jnp.where(isEntering, nElem, 1.)
  mu = n1 / n2
  cx_, cy_, cz_ = _cross3(nx, ny, nz, dx, dy, dz)
  sin2 = cx_ * cx_ + cy_ * cy_ + cz_ * cz_
  root = 1 - mu * mu * sin2
  tir = root < 0
  # tangential = n x (-n x d) = d - n (d.n)
  tx_, ty_, tz_ = dx - nx * dDotN, dy - ny * dDotN, dz - nz * dDotN
  # double-where (not maximum): sqrt'(0)=inf would NaN TIR rays' grads
  sq = jnp.where(tir, 0., jnp.sqrt(jnp.where(tir, 1., root)))
  sxx, syy, szz = mu * tx_ + nx * sq, mu * ty_ + ny * sq, mu * tz_ + nz * sq
  snx = jnp.where(tir, mx, sxx)
  sny = jnp.where(tir, my, syy)
  snz = jnp.where(tir, mz, szz)

  # grating (Ludwig 1970, incidence-side normal; see tracer.gratingDirection)
  if flags['hasGrating']:
    isReflG = gratType == GRATING_REFLECTION
    gn1 = jnp.where(isReflG, nMedium, 1.)
    gn2 = jnp.where(isReflG, nMedium, nElem)
    gmu = gn1 / gn2
    nix, niy, niz = -nx, -ny, -nz
    pgx, pgy, pgz = _norm3(*_cross3(gDirX, gDirY, gDirZ, nix, niy, niz))
    dgx, dgy, dgz = _norm3(*_cross3(nix, niy, niz, pgx, pgy, pgz))
    lamUm = wl / 1000.
    spacing = 1000. / gratLpm
    Tt = gratOrder * lamUm / (gn1 * spacing)
    V = gmu * _dot3(dx, dy, dz, nix, niy, niz)
    W = (gmu * gmu - 1 + Tt * Tt
         - 2 * gmu * Tt * _dot3(dx, dy, dz, dgx, dgy, dgz))
    disc = V * V - W
    evanescent = disc < 0
    gsq = jnp.where(evanescent, 0.,
                    jnp.sqrt(jnp.where(evanescent, 1., disc)))
    qg = jnp.where(isReflG, -V + gsq, -V - gsq)
    ggx, ggy, ggz = _norm3(gmu * dx - Tt * dgx + qg * nix,
                           gmu * dy - Tt * dgy + qg * niy,
                           gmu * dz - Tt * dgz + qg * niz)
    gratX = jnp.where(isReflG, jnp.where(isEntering, ggx, dx),
                      jnp.where(isEntering, ggx, snx))
    gratY = jnp.where(isReflG, jnp.where(isEntering, ggy, dy),
                      jnp.where(isEntering, ggy, sny))
    gratZ = jnp.where(isReflG, jnp.where(isEntering, ggz, dz),
                      jnp.where(isEntering, ggz, snz))
  else:
    isReflG = jnp.zeros_like(medium, dtype=bool)
    evanescent = jnp.zeros_like(medium, dtype=bool)
    gratX, gratY, gratZ = dx, dy, dz

  isMirror = optType == MIRROR
  isLens = optType == LENS
  isGrating = optType == GRATING
  isAbsorber = optType == ABSORBER

  ndx = jnp.where(isMirror, mx, jnp.where(isLens, snx,
                  jnp.where(isGrating, gratX, dx)))
  ndy = jnp.where(isMirror, my, jnp.where(isLens, sny,
                  jnp.where(isGrating, gratY, dy)))
  ndz = jnp.where(isMirror, mz, jnp.where(isLens, snz,
                  jnp.where(isGrating, gratZ, dz)))
  ndx, ndy, ndz = _norm3(ndx, ndy, ndz)

  # ---- stochastic scatter (reference: optical_group.py:281-325) ----
  if 'scatter' in scene and key is not None:
    sc = scene['scatter']
    N = dx.shape[0]
    # draw ONLY the uniforms this configuration consumes: threefry bits
    # cost real compute at (10, 1e6) per bounce; without discrete Dirac
    # events only 4 streams are used
    if 'phiDiscVals' in sc:
      u = jax.random.uniform(key, (8, N))
      uS, uM = (u[0], u[1], u[2], u[3]), (u[4], u[5], u[6], u[7])
    else:
      u4 = jax.random.uniform(key, (4, N))
      uS, uM = (u4[0], u4[1], u4[0], u4[1]), (u4[2], u4[3], u4[2], u4[3])
    Tin = sc['phiInv'].shape[2]
    thetaIn = jnp.arccos(jnp.clip(dDotN, -1., 1.))
    tinIdx = jnp.clip(jnp.round(thetaIn / (jnp.pi / 2)
                                * (Tin - 1)).astype(jnp.int32), 0, Tin - 1)
    # scatter kind slots (must match models/scatter.py)
    REFLECT, REFRACT_ENTER, REFRACT_EXIT, MODIFY = 0, 1, 2, 3
    kind = jnp.where(isMirror, REFLECT,
                     jnp.where(isEntering, REFRACT_ENTER, REFRACT_EXIT))
    applies = ((isMirror | isLens)
               & sc['flags'][elemIdx, kind] & hasHit)
    scConst = flags.get('scatterConst') if flags else None
    if scConst is not None:
      # conditioned fits evaluate at the CONTINUOUS incidence angle
      thetaInC = jnp.arccos(jnp.clip(dDotN, 0., 1.))
      thetaS, phiS = _scatterDrawConst(scConst, elemIdx, kind, thetaInC,
                                       uS[0], uS[1], uS[2], uS[3])
    else:
      thetaS, phiS = _scatterDraw(sc, elemIdx, kind, tinIdx, *uS)
    # lobe axis: incidence-side normal for mirrors (reflected lobe), forward
    # normal for lenses (transmitted lobe) — theta=0 is the face normal
    nSgn = jnp.where(isMirror, -1., 1.)
    lnx, lny, lnz = nx * nSgn, ny * nSgn, nz * nSgn
    # rotation axis normal x dIn; degenerate at normal incidence -> use an
    # arbitrary perpendicular of n
    axX, axY, axZ = _cross3(lnx, lny, lnz, dx, dy, dz)
    axLen2 = axX * axX + axY * axY + axZ * axZ
    altX, altY, altZ = _cross3(lnx, lny, lnz,
                               jnp.ones_like(lnx), jnp.zeros_like(lny),
                               jnp.zeros_like(lnz))
    alt2X, alt2Y, alt2Z = _cross3(lnx, lny, lnz,
                                  jnp.zeros_like(lnx), jnp.ones_like(lny),
                                  jnp.zeros_like(lnz))
    altLen2 = altX * altX + altY * altY + altZ * altZ
    useAlt = axLen2 < 1e-12
    axX = jnp.where(useAlt, jnp.where(altLen2 > 1e-12, altX, alt2X), axX)
    axY = jnp.where(useAlt, jnp.where(altLen2 > 1e-12, altY, alt2Y), axY)
    axZ = jnp.where(useAlt, jnp.where(altLen2 > 1e-12, altZ, alt2Z), axZ)
    axX, axY, axZ = _norm3(axX, axY, axZ)
    # out = Rot(n, phi) Rot(n x dIn, theta) n
    sx1, sy1, sz1 = _rot3(lnx, lny, lnz, axX, axY, axZ, thetaS)
    sx1, sy1, sz1 = _rot3(sx1, sy1, sz1, lnx, lny, lnz, phiS)
    ndx = jnp.where(applies, sx1, ndx)
    ndy = jnp.where(applies, sy1, ndy)
    ndz = jnp.where(applies, sz1, ndz)

    # modify step: rotate the outgoing direction itself
    appliesM = ((isMirror | isLens)
                & sc['flags'][elemIdx, MODIFY] & hasHit)
    if scConst is not None:
      thetaM, phiM = _scatterDrawConst(scConst, elemIdx,
                                       jnp.full_like(kind, MODIFY), thetaInC,
                                       uM[0], uM[1], uM[2], uM[3])
    else:
      thetaM, phiM = _scatterDraw(sc, elemIdx,
                                  jnp.full_like(kind, MODIFY), tinIdx, *uM)
    mAxX, mAxY, mAxZ = _cross3(ndx, ndy, ndz, dx, dy, dz)
    mLen2 = mAxX * mAxX + mAxY * mAxY + mAxZ * mAxZ
    mAxX = jnp.where(mLen2 < 1e-12, axX, mAxX)
    mAxY = jnp.where(mLen2 < 1e-12, axY, mAxY)
    mAxZ = jnp.where(mLen2 < 1e-12, axZ, mAxZ)
    mAxX, mAxY, mAxZ = _norm3(mAxX, mAxY, mAxZ)
    mx2, my2, mz2 = _rot3(ndx, ndy, ndz, mAxX, mAxY, mAxZ, thetaM)
    mx2, my2, mz2 = _rot3(mx2, my2, mz2, ndx, ndy, ndz, phiM)
    ndx = jnp.where(appliesM, mx2, ndx)
    ndy = jnp.where(appliesM, my2, ndy)
    ndz = jnp.where(appliesM, mz2, ndz)
    ndx, ndy, ndz = _norm3(ndx, ndy, ndz)

  lensExitToVacuum = isLens & ~isEntering & ~tir & (medium == elemIdx)
  gratTransEnter = isGrating & ~isReflG & isEntering
  gratTransExit = isGrating & ~isReflG & ~isEntering & ~tir
  newMedium = jnp.where((isLens & isEntering) | gratTransEnter, elemIdx,
                        jnp.where(lensExitToVacuum | gratTransExit,
                                  VACUUM_MEDIUM, medium))
  newPower = jnp.where(isMirror, power * reflectivity,
                       jnp.where(isAbsorber, 0., power))
  newPower = jnp.where(isGrating & isEntering & evanescent, 0., newPower)
  seqInc = (isMirror | isAbsorber | (optType == VACUUM)
            | lensExitToVacuum | (isGrating & isReflG & isEntering)
            | gratTransExit).astype(seq.dtype)

  records = dict(
      hitElem=jnp.where(hasHit & alive, elemIdx, -1),
      hitSurface=jnp.where(hasHit & alive, idx, -1),
      px=px, py=py, pz=pz, plx=plx, ply=ply,
      dirX=dx, dirY=dy, dirZ=dz,
      power=power,
      isEntering=isEntering,
      isHit=hasHit & alive,
      recordHit=hasHit & alive & recordHits,
      segValid=alive,
      segPower=powerBefore,
      segMedium=medium,
      oX=ox, oY=oy, oZ=oz,
  )

  powerTol = scene.get('powerTol', 1e-6)
  newAlive = alive & hasHit & (newPower >= powerTol)
  newState = (jnp.stack([px, py, pz], axis=-1),
              jnp.where(hasHit[:, None],
                        jnp.stack([ndx, ndy, ndz], axis=-1), d),
              jnp.where(hasHit, newPower, power),
              wl,
              jnp.where(hasHit, newMedium, medium),
              seq + jnp.where(hasHit, seqInc, 0),
              newAlive)
  return newState, records
