'''
On-device sampling from compiled random variables.

The reference draws all random numbers with per-process numpy and feeds them
through python loops (random_number_generator.py:467-560). Here the compiled
per-variable conditional inverse-CDF transforms are exported as JAX arrays so
that source sampling runs *inside* the jitted trace step: millions of
(theta, phi) draws per step, chained conditionally, with `jax.random` keyed
streams. Conditional draws use a vectorized binary search over the CDF rows
instead of materializing per-draw CDF columns, so HBM traffic stays at
O(N log R) gathered scalars.
'''

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def lerpInverseCdf(pairs, u, Q, rows=None):
  '''Linear interpolation, at quantiles u in [0, 1], of inverse-CDF rows
  tabulated on the uniform grid linspace(0, 1, Q) (np.interp semantics).
  `pairs` holds each row's (value[j], value[j + 1]) pairs flattened to
  (rows * (Q - 1), 2), so ONE 2-wide gather feeds the lerp; `rows` picks
  each draw's row (None: a single row).'''
  pos = u * (Q - 1)
  j = jnp.clip(pos.astype(jnp.int32), 0, Q - 2)
  frac = pos - j
  base = j if rows is None else rows * (Q - 1) + j
  pair = pairs[base]
  return pair[:, 0] + frac * (pair[:, 1] - pair[:, 0])


def nearestIndex(grid, x):
  '''Index of the nearest entry of sorted 1-D `grid` for each x (device).'''
  pos = jnp.clip(jnp.searchsorted(grid, x), 1, grid.shape[0] - 1)
  lo, hi = grid[pos - 1], grid[pos]
  return jnp.where(jnp.abs(x - lo) <= jnp.abs(hi - x), pos - 1, pos)


def interpInverseRows(cdf, values, rows, u):
  '''
  Row-wise inverse interpolation: for each draw j, find v such that
  cdf[rows[j], :] crosses u[j] and linearly interpolate into `values`.
  cdf rows are ascending with cdf[:, 0] == 0 and cdf[:, -1] == 1.
  Implemented as a batched binary search (log2(R) gathers of N scalars).
  '''
  R = cdf.shape[1]
  lo = jnp.zeros(rows.shape, dtype=jnp.int32)
  hi = jnp.full(rows.shape, R - 1, dtype=jnp.int32)
  steps = int(math.ceil(math.log2(max(R, 2))))

  def body(_, lh):
    lo, hi = lh
    mid = (lo + hi) // 2
    cm = cdf[rows, mid]
    goRight = u >= cm
    return (jnp.where(goRight, mid, lo), jnp.where(goRight, hi, mid))

  lo, hi = lax.fori_loop(0, steps, body, (lo, hi))
  c0, c1 = cdf[rows, lo], cdf[rows, hi]
  v0, v1 = values[lo], values[hi]
  frac = jnp.where(c1 > c0, (u - c0) / (c1 - c0), 0.)
  return v0 + frac * (v1 - v0)


def _tablesFromTransform(vrv, varI, dtype):
  '''Build the device table dict for one variable of a compiled
  VectorRandomVariable.'''
  import sympy as sy
  from .random_variables import _NumericTransform

  t = vrv._transforms[varI]
  discreteVals = np.asarray(getattr(t, 'discreteVals', np.zeros(0)), dtype=float)
  discreteProbs = np.asarray(getattr(t, 'discreteProbs', np.zeros(0)), dtype=float)

  if isinstance(t, _NumericTransform):
    values, cdf, laterGrids = t.values, t.cdf, t.laterGrids
  else:
    # analytic mode: tabulate the continuum part numerically
    smooth = (vrv._probabilityDensityExpr
              .replace(sy.Heaviside, lambda *a: 0)
              .replace(sy.DiracDelta, lambda *a: 0))
    if smooth == 0 and len(discreteVals):
      # purely discrete variable: dummy continuum table (never selected
      # because the discrete probabilities sum to one)
      l1, l2 = vrv._variableDomains.get(str(vrv._variables[varI]), (0., 1.))
      values = np.linspace(l1, l2, 2)
      cdf = np.array([[0., 1.]])
      laterGrids = []
    else:
      num = vrv._numericTransform(varI, exprOverride=smooth)
      values, cdf, laterGrids = num.values, num.cdf, num.laterGrids

  # zero-mass conditional rows would be NaN; replace with a uniform ramp so
  # they cannot poison downstream arithmetic (they are only reachable via
  # measure-zero conditioning values)
  ramp = np.linspace(0., 1., cdf.shape[1])
  cdf = np.where(np.isnan(cdf), ramp[None, :], cdf)

  # conditioning grids come from linspace in practice: record uniform-grid
  # parameters so nearest-index lookups become a round() instead of a
  # searchsorted binary-search loop
  gridMeta = []
  for g in laterGrids:
    g = np.asarray(g, dtype=float)
    steps = np.diff(g)
    uniform = len(g) > 1 and np.allclose(steps, steps[0], rtol=1e-6)
    gridMeta.append((bool(uniform), float(g[0]),
                     float(steps[0]) if len(g) > 1 else 1., len(g)))
  # host numpy here — buildDeviceTables post-processes these rows and
  # transfers everything to device exactly once at the end (device-side
  # dtype conversions would each cost one tiny XLA compile)
  npDtype = np.dtype(dtype.dtype if hasattr(dtype, 'dtype') else dtype)
  return dict(
      values=np.asarray(values, dtype=npDtype),
      cdf=np.asarray(cdf, dtype=npDtype),
      laterGrids=tuple(np.asarray(g, dtype=npDtype) for g in laterGrids),
      laterGridMeta=tuple(gridMeta),
      discreteVals=np.asarray(discreteVals, dtype=npDtype),
      discreteCum=np.cumsum(discreteProbs).astype(npDtype),
  )


def buildDeviceTables(vrv, dtype=jnp.float32, quantileRes=4097):
  '''
  Export a compiled VectorRandomVariable as a tuple of per-variable device
  table dicts (a pytree), ordered like vrv._variables. Pass the result to
  `deviceDraw`. When a `variableOrder` was given, the output rows of
  `deviceDraw` follow it.

  Each variable also carries a pre-inverted CDF tabulated on a uniform
  quantile grid (`invCdf`, shape (M, quantileRes)): drawing then costs two
  flat gathers + a lerp instead of a per-draw binary search over the CDF.
  '''
  if vrv._transforms is None:
    vrv.compile()
  tables = tuple(_tablesFromTransform(vrv, i, dtype)
                 for i in range(len(vrv._variables)))
  # pre-invert the CDF rows onto a uniform quantile grid; detect structure
  # that removes gathers entirely:
  #   * affine rows (uniform marginal)   -> closed form, zero gathers
  #   * all rows identical (separable)   -> no row-index conditioning
  #   * (v[j], v[j+1]) pair rows         -> one 2-wide gather, not two
  q = np.linspace(0., 1., quantileRes)
  npDtype = np.dtype(dtype.dtype if hasattr(dtype, 'dtype') else dtype)
  newTables = []
  for t in tables:
    cdf = np.asarray(t['cdf'], dtype=np.float64)
    values = np.asarray(t['values'], dtype=np.float64)
    inv = np.stack([np.interp(q, row, values) for row in cdf])
    t = dict(t)
    rowsEqual = bool(np.all(np.abs(inv - inv[0:1])
                            <= 1e-7 * max(np.ptp(values), 1e-30)))
    if rowsEqual:
      inv = inv[:1]
    lin = np.linspace(inv[0, 0], inv[0, -1], inv.shape[1])
    affine = rowsEqual and bool(
        np.all(np.abs(inv[0] - lin) <= 1e-6 * max(np.ptp(values), 1e-30)))
    t['invCdf'] = inv.astype(npDtype)
    pairs = np.stack([inv[:, :-1], inv[:, 1:]], axis=-1)  # (M, Q-1, 2)
    t['invCdfPairs'] = pairs.reshape(-1, 2).astype(npDtype)
    t['affine'] = (affine, float(inv[0, 0]), float(inv[0, -1]))
    t['rowsEqual'] = rowsEqual
    # single device transfer per array, already in the target dtype
    newTables.append({k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                          else (tuple(jnp.asarray(g) for g in v)
                                if k == 'laterGrids' else v))
                      for k, v in t.items()})
  tables = tuple(newTables)
  names = [str(v) for v in vrv._variables]
  if vrv._variableOrder:
    order = tuple(names.index(v) for v in vrv._variableOrder if v in names)
  else:
    order = tuple(range(len(names)))
  return dict(tables=tables, order=jnp.asarray(order, dtype=jnp.int32),
              names=tuple(names))


def deviceDraw(deviceTables, key, N, stratified=False):
  '''
  Draw N samples on device; returns an array of shape (numVariables, N) with
  rows ordered by the variable order the tables were built with. Jittable
  (N static). `stratified=True` feeds latin-hypercube quantiles through the
  same transforms (the device analog of drawPseudo).
  '''
  tables = deviceTables['tables']
  k = len(tables)
  drawn = [None] * k
  for i in reversed(range(k)):
    t = tables[i]
    key, kU, kPerm, kD = jax.random.split(key, 4)
    if stratified:
      u = (jnp.arange(N, dtype=t['values'].dtype)
           + jax.random.uniform(kU, (N,), dtype=t['values'].dtype)) / N
      u = jax.random.permutation(kPerm, u)
    else:
      u = jax.random.uniform(kU, (N,), dtype=t['values'].dtype)

    laterGrids = t['laterGrids']
    Q = t['invCdf'].shape[1]
    affine, aLo, aHi = t.get('affine', (False, 0., 1.))
    rowsEqual = t.get('rowsEqual', False)
    if affine:
      # uniform marginal: closed form, no gathers at all
      out = aLo + u * (aHi - aLo)
    else:
      rows = None
      if laterGrids and not rowsEqual:
        rows = jnp.zeros((N,), dtype=jnp.int32)
        meta = t.get('laterGridMeta', ((False,) * 4,) * len(laterGrids))
        for g, m, vals in zip(laterGrids, meta,
                              [drawn[j2] for j2 in range(i + 1, k)]):
          uniform, lo, step, L = m
          if uniform:
            near = jnp.clip(jnp.round((vals - lo) / step).astype(jnp.int32),
                            0, L - 1)
          else:
            near = nearestIndex(g, vals).astype(jnp.int32)
          rows = rows * g.shape[0] + near
      out = lerpInverseCdf(t['invCdfPairs'], u, Q, rows)

    if t['discreteVals'].shape[0]:
      u2 = jax.random.uniform(kD, (N,), dtype=t['values'].dtype)
      cum = t['discreteCum']
      idx = jnp.clip(jnp.searchsorted(cum, u2, side='left'),
                     0, cum.shape[0] - 1)
      out = jnp.where(u2 <= cum[-1], t['discreteVals'][idx], out)
    drawn[i] = out

  result = jnp.stack(drawn)
  return result[deviceTables['order']]


def fitPiecewisePoly2d(rows, cond, maxRects=24, degU=8, degC=6,
                       relTol=5e-3):
  '''Fit a FAMILY of inverse CDFs `rows` ((T, Q), each row tabulated on a
  uniform [0,1] quantile grid for conditioning value cond[t]) as bivariate
  piecewise polynomials f(u, c) over adaptive RECTANGLES in
  (quantile, scaled conditioning value): one (degU+1) x (degC+1)
  coefficient grid per rectangle in per-rect scaled coordinates. The worst
  rectangle is bisected along whichever dimension reduces its children's
  error more — u splits resolve the inverse-CDF boundary layers at
  u -> 0/1, c splits resolve the domain-clipping layers at the edges of
  the incidence-angle range (where the lobe runs into theta = 0 or pi/2
  and the family stops being a pure shift).
  Evaluation (evalPwpoly2d) is Horner in u with coefficients Horner in the
  scaled conditioning value, rect-selected by compare/where — pure FMA +
  select columns, no gathers. This is what lets theta_in-CONDITIONED
  scatter lobes draw without the row-indexed random gather of the
  tabulated path (reference semantics:
  optical_group.py:281-325 re-compiles the scatter VRV per hit with
  theta_in substituted).
  Acceptance: 99.5th-percentile error <= relTol * range with a hard
  6 * relTol * range cap on the max. Since u is drawn uniformly, the MEAN
  |inverse-CDF error| equals the Wasserstein-1 distance of the sampled
  distribution, so a percentile criterion (not sup-norm) is the
  statistically meaningful one; narrow boundary layers with slightly
  larger pointwise error contribute O(relTol * layerWidth) to W1. For
  calibration, the exact gather path itself quantizes theta_in to the
  nearest of THETA_IN_RES grid rows — a +-(pi/2)/64 ~ 24.5 mrad lobe-shift
  error, ~3x this fit tolerance. Returns
  ('pwpoly2d', rects, lo, hi, cMid, cHalf) with rect =
  (a, b, ca, cb, midU, halfU, midC, halfC, coeffs), or None at failure.'''
  rows = np.asarray(rows, dtype=float)
  cond = np.asarray(cond, dtype=float)
  T, Q = rows.shape
  q = np.linspace(0., 1., Q)
  rng = max(np.ptp(rows), 1e-30)
  cMid = (cond.max() + cond.min()) / 2.
  cHalf = max((cond.max() - cond.min()) / 2., 1e-9)
  cS = (cond - cMid) / cHalf
  nU = 4 * (degU + 1)              # per-rect sample grids (always well
  nC = max(4 * (degC + 1), T)      # conditioned, however small the rect)

  def fitRect(a, b, ca, cb):
    midU, halfU = (a + b) / 2., max((b - a) / 2., 1e-9)
    midC, halfC = (ca + cb) / 2., max((cb - ca) / 2., 1e-9)
    us = np.linspace(a, b, nU)
    cs = np.linspace(ca, cb, nC)
    onU = np.stack([np.interp(us, q, r) for r in rows])    # (T, nU)
    seg = np.stack([[np.interp(c, cS, onU[:, i]) for i in range(nU)]
                    for c in cs])                          # (nC, nU)
    x = (us - midU) / halfU
    cc = (cs - midC) / halfC
    X = np.broadcast_to(x, (nC, nU))
    C = np.broadcast_to(cc[:, None], (nC, nU))
    cols = [(X ** i) * (C ** j)
            for i in range(degU + 1) for j in range(degC + 1)]
    A = np.stack(cols, axis=-1).reshape(-1, (degU + 1) * (degC + 1))
    y = seg.reshape(-1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    res = np.abs(A @ sol - y)
    cf = sol.reshape(degU + 1, degC + 1)
    rect = (a, b, ca, cb, midU, halfU, midC, halfC,
            tuple(tuple(float(v) for v in row) for row in cf))
    return rect, float(np.quantile(res, 0.995)), float(res.max())

  # initial tiling: the classic inverse-CDF boundary-layer u splits
  rects = [fitRect(a, b, -1., 1.)
           for a, b in ((0., .03), (.03, .97), (.97, 1.))]
  tol, cap = relTol * rng, 6. * relTol * rng
  while True:
    bad = [i for i, (_r, p, m) in enumerate(rects) if p > tol or m > cap]
    if not bad:
      return ('pwpoly2d', tuple(r for r, _p, _m in rects),
              float(rows.min()), float(rows.max()),
              float(cMid), float(cHalf))
    if len(rects) >= maxRects:
      return None
    worst = max(bad, key=lambda i: rects[i][1] + rects[i][2])
    a, b, ca, cb = rects[worst][0][:4]
    # bisect along the dimension whose children fit better
    uKids = [fitRect(a, (a + b) / 2, ca, cb),
             fitRect((a + b) / 2, b, ca, cb)]
    cKids = [fitRect(a, b, ca, (ca + cb) / 2),
             fitRect(a, b, (ca + cb) / 2, cb)]
    score = lambda kids: max(p + m for _r, p, m in kids)
    kids = uKids if score(uKids) <= score(cKids) else cKids
    rects[worst:worst + 1] = kids


def fitPoly1d(vals, cond, deg=10, relTol=1e-4):
  '''Fit vals(cond) as one scaled-coordinate Horner polynomial
  ('poly1d', mid, half, coeffsAscending); collapses to ('const', v) for
  flat rows. Used for theta_in-dependent discrete (DiracDelta) event
  values/probabilities — e.g. theta_refl(theta_in) of an ideal-specular
  delta. None at tolerance failure.'''
  vals = np.asarray(vals, dtype=float)
  cond = np.asarray(cond, dtype=float)
  rng = float(np.ptp(vals))
  scale = max(np.abs(vals).max(), 1.)
  if rng <= 1e-9 * scale:
    return ('const', float(vals[0]))
  mid = (cond.max() + cond.min()) / 2.
  half = max((cond.max() - cond.min()) / 2., 1e-9)
  s = (cond - mid) / half
  for d in range(2, deg + 1):
    c = np.polyfit(s, vals, d)
    if np.abs(np.polyval(c, s) - vals).max() <= relTol * max(rng, 1e-3):
      return ('poly1d', float(mid), float(half),
              tuple(float(x) for x in c[::-1]))
  return None


def evalPwpoly(spec, u):
  '''Piecewise Horner evaluation of a fitPiecewisePoly spec (python
  constants -> fused elementwise ops; used by the batch tracer's scatter
  draws).'''
  _, segs, lo, hi = spec
  out = None
  for a, _b, mid, half, coeffs in segs:
    s = (u - mid) * (1.0 / half)
    acc = jnp.full_like(u, coeffs[-1])
    for c in reversed(coeffs[:-1]):
      acc = acc * s + c
    out = acc if out is None else jnp.where(u >= a, acc, out)
  return jnp.clip(out, lo, hi)


def evalPwpoly2d(spec, u, c):
  '''Bivariate piecewise Horner evaluation of a fitPiecewisePoly2d spec:
  per rectangle, Horner in scaled u whose coefficients are Horner
  polynomials in the scaled conditioning value c; rect selection by
  compare/where (points on shared edges match either side — both
  polynomials agree there to fit tolerance). c outside the fitted range
  clamps to the nearest rect (scatter tables span the full incidence
  range, so this only absorbs float round-off).'''
  _, rects, lo, hi, cMid, cHalf = spec
  s = (c - cMid) * (1.0 / cHalf)
  out = None
  for a, _b, ca, cb, midU, halfU, midC, halfC, coeffs in rects:
    x = (u - midU) * (1.0 / halfU)
    cc = (s - midC) * (1.0 / halfC)
    acc = None
    for rowU in reversed(coeffs):          # ascending u powers reversed
      h = jnp.full_like(u, rowU[-1])
      for cj in reversed(rowU[:-1]):
        h = h * cc + cj
      acc = h if acc is None else acc * x + h
    if out is None:
      out = acc
    else:
      m = (u >= a) & (u <= _b) & (s >= ca) & (s <= cb)
      out = jnp.where(m, acc, out)
  return jnp.clip(out, lo, hi)


def fitLowRankTheta(rowsT, cond, phiGrid, maxRank=3, relTol=5e-3):
  '''Low-rank separable fit of a theta|phi-COUPLED conditional inverse-CDF
  family (round-4 verdict #4): rowsT (Tin, M, Q) tabulates the theta
  inverse CDF per (incidence angle, phi bin). SVD over the phi axis gives
  thetaInv(u; theta_in, phi) ~= sum_k A_k(u, theta_in) * B_k(phi); each
  A_k is fitted as a pwpoly2d in (quantile, theta_in) and each B_k as a
  poly1d in phi — so a coupled draw costs K pwpoly2d evaluations instead
  of a row-indexed random gather. Acceptance mirrors fitPiecewisePoly2d: 99.5th-percentile
  reconstruction error <= relTol * range, max <= 6x. Returns
  ('lowrank', ((aspec, bspec), ...), lo, hi) or None — callers then keep
  the exact gather path.'''
  rowsT = np.asarray(rowsT, dtype=float)
  Tin, M, Q = rowsT.shape
  rng = max(np.ptp(rowsT), 1e-30)
  tol, cap = relTol * rng, 6. * relTol * rng
  X = rowsT.transpose(1, 0, 2).reshape(M, Tin * Q)
  U, s, Vt = np.linalg.svd(X, full_matrices=False)
  q = np.linspace(0., 1., Q)
  uFlat = jnp.asarray(np.tile(q, Tin))
  cFlat = jnp.asarray(np.repeat(np.asarray(cond, float), Q))
  phiJ = jnp.asarray(np.asarray(phiGrid, float))
  comps = []
  recon = np.zeros_like(rowsT)
  for k in range(min(maxRank, len(s))):
    if s[k] <= 1e-12 * max(s[0], 1e-30):
      break
    A = (s[k] * Vt[k]).reshape(Tin, Q)
    B = U[:, k]
    aspec = fitPiecewisePoly2d(A, cond, relTol=relTol)
    bspec = fitPoly1d(B, phiGrid, deg=12, relTol=1e-3)
    if bspec is None:
      # phi components are typically PERIODIC (lobe widths repeat over
      # the azimuth) — the trigonometric basis succeeds where the
      # polynomial one leaves percent-level error
      bspec = fitFourier(B, phiGrid, relTol=1e-3,
                         maxHarmonics=min(15, (len(phiGrid) - 1) // 2))
    if aspec is None or bspec is None:
      return None
    comps.append((aspec, bspec))
    Av = np.asarray(evalPwpoly2d(aspec, uFlat, cFlat)).reshape(Tin, Q)
    Bv = np.asarray(evalFourier(bspec, phiJ) if bspec[0] == 'fourier'
                    else evalPoly1d(bspec, phiJ)) * np.ones(M)
    recon = recon + Av[:, None, :] * Bv[None, :, None]
    err = np.abs(recon - rowsT)
    if float(np.quantile(err, 0.995)) <= tol and float(err.max()) <= cap:
      return ('lowrank', tuple(comps),
              float(rowsT.min()), float(rowsT.max()))
  return None


def fitFourier(vals, x, maxHarmonics=12, relTol=1e-3):
  '''Least-squares trigonometric fit vals(x) ~= c0 + sum_m am cos(mx) +
  bm sin(mx) — the right basis for the PERIODIC phi components of a
  low-rank coupled-scatter expansion (a degree-20 polynomial left ~5% max
  error on an astigmatic lobe's phi profile; 8 harmonics fit it to 1e-4).
  Returns ('fourier', c0, ((a1, b1), ...)) or None.'''
  vals = np.asarray(vals, dtype=float)
  x = np.asarray(x, dtype=float)
  rng = max(np.ptp(vals), 1e-30)
  for Mh in range(2, maxHarmonics + 1):
    cols = [np.ones_like(x)]
    for m in range(1, Mh + 1):
      cols += [np.cos(m * x), np.sin(m * x)]
    A = np.stack(cols, axis=-1)
    sol, *_ = np.linalg.lstsq(A, vals, rcond=None)
    if np.abs(A @ sol - vals).max() <= relTol * rng:
      return ('fourier', float(sol[0]),
              tuple((float(sol[1 + 2 * m]), float(sol[2 + 2 * m]))
                    for m in range(Mh)))
  return None


def evalFourier(spec, x):
  '''Evaluate a fitFourier spec via the Chebyshev angle-addition
  recurrence: one cos/sin pair, then FMAs only.'''
  _, c0, terms = spec
  c1, s1 = jnp.cos(x), jnp.sin(x)
  out = c0 + terms[0][0] * c1 + terms[0][1] * s1
  cp, sp = jnp.ones_like(x), jnp.zeros_like(x)
  cm, sm = c1, s1
  for m in range(2, len(terms) + 1):
    cm, cp = 2. * c1 * cm - cp, cm
    sm, sp = 2. * c1 * sm - sp, sm
    am, bm = terms[m - 1]
    out = out + am * cm + bm * sm
  return out


def evalLowRankTheta(spec, u, thetaIn, phi):
  '''Evaluate a fitLowRankTheta spec: sum of K separable terms, clamped to
  the tabulated theta range. Pure FMA/select columns.'''
  _, comps, lo, hi = spec
  out = None
  for aspec, bspec in comps:
    bv = (evalFourier(bspec, phi) if bspec[0] == 'fourier'
          else evalPoly1d(bspec, phi))
    term = evalPwpoly2d(aspec, u, thetaIn) * bv
    out = term if out is None else out + term
  return jnp.clip(out, lo, hi)


def evalPoly1d(spec, c):
  '''Evaluate a fitPoly1d spec on a column (or return the scalar for
  'const' — jnp broadcasting handles it at the use site).'''
  if spec[0] == 'const':
    return spec[1]
  _, mid, half, coeffs = spec
  s = (c - mid) * (1.0 / half)
  acc = jnp.full_like(c, coeffs[-1])
  for cj in reversed(coeffs[:-1]):
    acc = acc * s + cj
  return acc


def evalDiscreteEvents(disc, c, u, cont):
  '''Apply a tuple of fitted discrete (DiracDelta) scatter events
  ((cumSpec, valSpec), ...) conditioned on `c`: reproduces the gather
  path's selection (tracing/batch_tracer._scatterDraw — the event index is
  the count of cumulative probabilities below the uniform `u`; u beyond
  the final cumulative keeps the continuous draw `cont`). Reference event
  semantics: random_number_generator.py:250-288 (Heaviside steps of the
  CDF become discrete events with their jump heights as probabilities).
  Pure compare/select ops.'''
  if not disc:
    return cont
  out = None
  prevCum = None
  for cumSpec, valSpec in disc:
    v = evalPoly1d(valSpec, c)
    out = v if out is None else jnp.where(u > prevCum, v, out)
    prevCum = evalPoly1d(cumSpec, c)
  return jnp.where(u <= prevCum, out, cont)


def fitPiecewisePoly(inv, maxSegments=12, deg=9, relTol=5e-3):
  '''Fit the tabulated inverse CDF `inv` (uniform quantile grid) as a few
  Horner polynomials in per-segment scaled coordinates (the scatter-lobe
  fits of tracing.batch_tracer.scatterConstants). Inverse CDFs of
  truncated smooth densities have boundary layers at u=0 (sqrt from the
  area Jacobian) and u=1 (thin tail), so fitting starts from the segment
  split [0, .03, .97, 1] and refines the worst segment until the max error
  is below relTol * range. Returns ('pwpoly', segments, lo, hi) or None
  if the tolerance is unmet at maxSegments.'''
  q = np.linspace(0., 1., inv.shape[0])
  qd = np.linspace(0., 1., 40001)
  ref = np.interp(qd, q, inv)
  rng = max(np.ptp(inv), 1e-30)
  splits = [0., .03, .97, 1.]

  def fit(splits):
    segs, errs = [], []
    for a, b in zip(splits[:-1], splits[1:]):
      m = (qd >= a) & (qd <= b)
      mid, half = (a + b) / 2., max((b - a) / 2., 1e-9)
      s = (qd[m] - mid) / half
      d = min(deg, max(1, m.sum() - 1))
      c = np.polyfit(s, ref[m], d)[::-1]          # ascending coeffs
      est = np.polyval(c[::-1], s)
      segs.append((a, b, mid, half, tuple(float(x) for x in c)))
      errs.append(float(np.abs(est - ref[m]).max()))
    return segs, errs

  while True:
    segs, errs = fit(splits)
    worst = int(np.argmax(errs))
    if errs[worst] <= relTol * rng:
      return ('pwpoly', tuple(segs), float(inv.min()), float(inv.max()))
    if len(splits) - 1 >= maxSegments:
      return None
    a, b = splits[worst], splits[worst + 1]
    splits = sorted(set(splits) | {(a + b) / 2.})
