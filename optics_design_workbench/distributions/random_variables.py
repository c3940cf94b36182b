'''
Random variables defined by arbitrary symbolic probability-density
expressions, compiled to fast sampling transforms.

Capability parity with the reference's random-variable compiler
(reference: distributions/random_number_generator.py:54-802):

  * `VectorRandomVariable(probabilityDensity, variableDomains,
    numericalResolutions, variableOrder)` — compiles a sympy expression to a
    chain of per-variable conditional inverse-transform samplers. An
    *analytic* path symbolically integrates the PDF marginal-by-marginal and
    solves the CDF for the quantile (with a wall-clock timeout), detecting
    DiracDelta discrete events via Heaviside steps and sampling them with
    their correct probabilities; a *numeric* fallback tabulates the PDF on a
    grid, builds conditional cumulative tables and inverts by interpolation.
  * `draw(N)` — chained conditional inverse-transform sampling, last variable
    first (marginalized over earlier ones), earlier variables conditioned on
    the already-drawn later ones.
  * `drawPseudo(N)` — low-discrepancy draw whose empirical histogram matches
    the target density much closer than i.i.d. sampling. Batch-first redesign:
    instead of the reference's overdraw-and-trim loop
    (random_number_generator.py:562-682) we use stratified (latin-hypercube)
    quantiles through the same inverse transforms, which bounds each
    marginal's per-bin error at ±1 sample by construction.
  * `findGrid(N)` — deterministic 1-D grids with local density proportional
    to the PDF (for ray fans).
  * `ScalarRandomVariable`, `SampledVectorRandomVariable` — 1-variable
    wrapper, and a variable built from tabulated `(ranges, gridProbs)`.

On top of the host API, `deviceTables()` exports the compiled conditional
CDF tables as JAX arrays for on-device sampling inside jitted trace steps
(see distributions/device_sampler.py) — the reference has no analog, its
sampling is per-process numpy.
'''

import math
import signal
import threading
import time
import warnings

import numpy as np
import sympy as sy

from . import points_by_density
from ..utils import io

_DEFAULT_RNG = np.random.default_rng()


def setGlobalSeed(seed):
  '''Seed the host-side RNG used by draw()/drawPseudo() when no generator is
  passed (reference: simulation/__init__.py:15-32 seeds numpy globally).'''
  global _DEFAULT_RNG
  _DEFAULT_RNG = np.random.default_rng(seed)


class _Timeout:
  '''CPU-time guard around sympy calls. sympy swallows ordinary exceptions
  internally, so like the reference we must raise KeyboardInterrupt from a
  SIGALRM handler to reliably abort a hung solve (reference:
  random_number_generator.py:23-37). Hardened beyond the reference's bare
  `signal.alarm`:
    * the budget is measured in MAIN-THREAD CPU time (time.thread_time),
      not wall clock — machine load (concurrent test workers, XLA compile
      threads) cannot expire the analytic budget and silently flip a
      deterministic 'analytic' compile into 'numeric' mode. A wall-clock
      ceiling of 10x the budget still bounds blocking (non-CPU) hangs.
    * the handler is fenced by an `_active` flag so a late alarm delivered
      after the guarded region (e.g. while the interpreter is inside an
      XLA GC callback) is a no-op instead of killing the host program; the
      previous handler is restored on exit; and a raise that gets
      swallowed by an unraisable-exception context (gc.callbacks) re-arms
      a short retry timer so the hung solve is still interrupted at the
      next bytecode boundary in a normal frame.
  Outside the main thread (where signals are unavailable) the guard
  degrades to a post-hoc deadline check.'''

  def __init__(self, cpuDeadline, wallDeadline=None):
    self.cpuDeadline = cpuDeadline
    self.wallDeadline = wallDeadline if wallDeadline is not None \
        else time.time() + 10 * max(cpuDeadline - time.thread_time(), 0.)
    self._installed = False
    self._active = False
    self._prevHandler = None

  def _expired(self):
    return (time.thread_time() >= self.cpuDeadline
            or time.time() >= self.wallDeadline)

  def _remaining(self):
    return min(self.cpuDeadline - time.thread_time(),
               self.wallDeadline - time.time())

  def __enter__(self):
    if self._expired():
      raise RuntimeError('time is up')
    if threading.current_thread() is threading.main_thread():
      def handler(sig, frame):
        if not self._active:
          return  # late or spurious alarm: never interrupt unrelated code
        if not self._expired():
          # wall time passed but the main thread was starved of CPU (load):
          # re-arm for the remaining CPU budget
          signal.setitimer(signal.ITIMER_REAL,
                           max(self._remaining(), .05))
          return
        # a raise inside a gc callback frame (observed: jax's
        # _xla_gc_callback) is swallowed as an "unraisable exception" and
        # noisily printed — don't raise there, just retry shortly so the
        # interrupt lands at a bytecode boundary in a normal frame
        name = frame.f_code.co_name if frame is not None else ''
        if frame is None or name == '_xla_gc_callback' \
            or frame.f_code.co_filename.endswith('gc.py'):
          signal.setitimer(signal.ITIMER_REAL, .05)
          return
        # re-arm before raising: if this raise still lands in a context
        # that swallows exceptions, the retry fires regardless
        signal.setitimer(signal.ITIMER_REAL, .25)
        raise KeyboardInterrupt('time is up')
      self._prevHandler = signal.signal(signal.SIGALRM, handler)
      self._active = True
      signal.setitimer(signal.ITIMER_REAL, max(self._remaining(), .01))
      self._installed = True
    return self

  def __exit__(self, exc_type, exc, tb):
    if self._installed:
      self._active = False
      signal.setitimer(signal.ITIMER_REAL, 0)
      try:
        signal.signal(signal.SIGALRM, self._prevHandler)
      except (TypeError, ValueError):
        signal.signal(signal.SIGALRM, signal.SIG_DFL)
    if exc_type is KeyboardInterrupt and str(exc) == 'time is up':
      raise RuntimeError('time is up')
    return False


def _lambdify(args, expr):
  return sy.lambdify(args, expr, modules=['numpy', 'scipy'])


def _nearestIndex(grid, x):
  '''Vectorized nearest-gridpoint index lookup on a sorted 1-D grid.'''
  grid = np.asarray(grid)
  x = np.asarray(x)
  pos = np.searchsorted(grid, x)
  pos = np.clip(pos, 1, len(grid) - 1)
  lo, hi = grid[pos - 1], grid[pos]
  return np.where(np.abs(x - lo) <= np.abs(hi - x), pos - 1, pos)


class _AnalyticTransform:
  '''Inverse-transform sampler for one variable, from closed-form CDF
  inversion. `inverses` are callables f(u, *laterValues) with laterValues
  the already-drawn values of all later variables in ascending variable
  order; exactly one inverse is expected to land inside the domain.'''

  kind = 'analytic'

  def __init__(self, inverses, domain, discreteVals, discreteProbs,
               expressions=None):
    self.inverses = inverses
    self.domain = domain
    self.discreteVals = np.asarray(discreteVals, dtype=float)
    self.discreteProbs = np.asarray(discreteProbs, dtype=float)
    self.expressions = expressions or ('n.a.', 'n.a.', ['n.a.'])

  def __call__(self, u, laterValues, rng):
    l1, l2 = self.domain
    if self.inverses:
      with np.errstate(all='ignore'), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        candidates = np.stack(
            [np.broadcast_to(
                np.asarray(f(np.asarray(u, dtype=float), *laterValues)),
                np.shape(u)).astype(complex)
             for f in self.inverses])
      # invalid branches yield NaN (or complex values); keep reals inside
      # the domain (with a small boundary tolerance — deltas/steps sitting
      # exactly on a domain edge otherwise produce spurious misses)
      real = np.where(np.abs(candidates.imag) < 1e-9, candidates.real, np.nan)
      tol = 1e-9 * max(abs(l2 - l1), 1.)
      valid = (l1 - tol <= real) & (real <= l2 + tol)
      nValid = valid.sum(axis=0)
      if np.any(nValid > 1):
        raise ValueError('more than one valid inverse-CDF solution found in '
                         f'domain ({self.expressions[2]})')
      firstValid = np.argmax(valid, axis=0)
      out = np.where(nValid >= 1,
                     np.clip(real[firstValid, np.arange(real.shape[1])],
                             l1, l2),
                     np.nan)
    else:
      out = np.full(np.shape(u), np.nan)
    # discrete-event overwrite with correct probabilities
    if len(self.discreteVals):
      u2 = rng.random(np.shape(u))
      cum = np.cumsum(self.discreteProbs)
      idx = np.searchsorted(cum, u2, side='left')
      isDiscrete = u2 <= cum[-1]
      out = np.where(isDiscrete,
                     self.discreteVals[np.clip(idx, 0, len(self.discreteVals) - 1)],
                     out)
      # discrete values sitting on a domain edge can differ from the domain
      # bound by an ulp (sympy pi vs numpy pi); snap them inside
      tol = 1e-9 * max(abs(l2 - l1), 1.)
      out = np.where(np.abs(out - np.clip(out, l1, l2)) <= tol,
                     np.clip(out, l1, l2), out)
    return out


class _NumericTransform:
  '''Inverse-transform sampler for one variable from a tabulated conditional
  CDF. `cdf` has shape (M, R) where M indexes the flattened grid of all
  later variables (C-order over their in-between grids) and R matches
  `values`; rows are normalized to end at 1.'''

  kind = 'numeric'

  def __init__(self, values, cdf, laterGrids, domain):
    self.values = np.asarray(values, dtype=float)
    self.cdf = np.asarray(cdf, dtype=float)
    self.laterGrids = [np.asarray(g, dtype=float) for g in laterGrids]
    self.domain = domain
    self.discreteVals = np.zeros(0)
    self.discreteProbs = np.zeros(0)

  def __call__(self, u, laterValues, rng):
    u = np.atleast_1d(np.asarray(u, dtype=float))
    if self.laterGrids:
      flat = np.zeros(u.shape, dtype=np.int64)
      for grid, vals in zip(self.laterGrids, laterValues):
        flat = flat * len(grid) + _nearestIndex(grid, np.atleast_1d(vals))
      out = np.empty_like(u)
      # interpolate per unique row to stay vectorized without (N, R) gathers
      for r in np.unique(flat):
        mask = flat == r
        out[mask] = np.interp(u[mask], self.cdf[r], self.values)
    else:
      out = np.interp(u, self.cdf[0], self.values)
    return out


class VectorRandomVariable:
  '''
  Vector-valued random variable defined by a symbolic probability density
  (reference: random_number_generator.py:54-69).
  '''

  def __init__(self, probabilityDensity, variableDomains={},
               numericalResolutions={}, variableOrder=None,
               warnIfDiscretizationStepAbove=5e-2):
    self._probabilityDensity = probabilityDensity
    self._probabilityDensityBaseExpr = None
    self._variables = None
    self._variableDomains = dict(variableDomains)
    self._numericalResolutions = numericalResolutions
    self._variableOrder = list(variableOrder) if variableOrder else None
    self._constantsDict = {}
    self._mode = 'not yet compiled'
    self._needsRecompile = True
    self._warnIfDiscretizationStepAbove = warnIfDiscretizationStepAbove
    self._transforms = None

  # ------------------------------------------------------------------ compile

  def compile(self, timeout=2, disableAnalytical=False, **constants):
    '''
    Compile the symbolic density into per-variable sampling transforms:
    analytic inverse-transform if sympy can integrate and invert the CDF
    within `timeout` seconds, else a tabulated numeric fallback
    (reference: random_number_generator.py:72-119).
    '''
    # CPU-time budget (load-independent: concurrent processes cannot flip
    # the compile mode) with a 10x wall-clock ceiling for true hangs
    self._deadline = time.thread_time() + timeout
    self._wallDeadline = time.time() + 10 * timeout
    self._setConstants(**constants)
    if not self._needsRecompile:
      return

    try:
      if disableAnalytical:
        raise ValueError('analytic mode disabled')
      self._transforms = [self._analyticTransform(i)
                          for i in range(len(self._variables))]
      self._mode = 'analytic'
      self._needsRecompile = False
      # validate: a small draw must not produce NaNs
      probe = self.draw(N=10)
      vals = probe.values() if isinstance(probe, dict) else [probe]
      for v in vals:
        if np.any(np.isnan(np.asarray(v, dtype=float))):
          raise ValueError('analytic mode was not successful')
    except Exception:
      if sy.sympify(self._probabilityDensity).find(sy.DiracDelta):
        raise ValueError(
            'cannot use numeric mode for expression containing DiracDelta')
      self._transforms = [self._numericTransform(i)
                          for i in range(len(self._variables))]
      self._mode = 'numeric'
      self._needsRecompile = False

  def mode(self):
    return self._mode

  def showExpressions(self, simplify=True):
    '''Pretty-print the compiled expressions for debugging (reference:
    random_number_generator.py:126-145).'''
    print('probability density expression:', self._probabilityDensityExpr,
          ' variables:', self._variables)
    for i, var in enumerate(self._variables):
      t = self._transforms[i]
      probDens, integral, inverted = getattr(t, 'expressions',
                                             ('n.a.', 'n.a.', ['n.a.']))
      if simplify and not isinstance(probDens, str):
        probDens, integral = probDens.simplify(), integral.simplify()
        inverted = [s.simplify() for s in inverted]
      cond = 'conditional ' if i < len(self._variables) - 1 else ''
      print(f'variable "{var}" {cond}probability density:')
      print('  prob. dens.:', probDens)
      print('  integrated prob. dens.:', integral)
      print('  inverted integral solution(s):', inverted)

  def _setConstants(self, **kwargs):
    if self._probabilityDensityBaseExpr is None:
      self._probabilityDensityBaseExpr = sy.sympify(self._probabilityDensity)
    expr = self._probabilityDensityBaseExpr

    substituted = {}
    for name, val in kwargs.items():
      if name in [str(s) for s in expr.free_symbols]:
        expr = expr.subs(name, val)
        substituted[name] = val
    if not self._needsRecompile and self._constantsDict == substituted:
      return
    self._needsRecompile = True
    self._constantsDict = substituted

    self._variables = list(expr.free_symbols)
    if self._variableOrder:
      ordered = []
      for varName in self._variableOrder:
        names = [str(v) for v in self._variables]
        if varName in names:
          ordered.append(self._variables.pop(names.index(varName)))
      self._variables = ordered + self._variables

    # replace free symbols with real-assumption symbols (sign assumptions
    # from the domains help sympy's solve pick the right branch)
    replaced = []
    for sym in self._variables:
      l1, l2 = self._variableDomains.get(str(sym), (-np.inf, np.inf))
      assumptions = (dict(nonnegative=True) if l1 >= 0
                     else dict(nonpositive=True) if l2 <= 0 else {})
      realSym = sy.Symbol(str(sym), real=True, **assumptions)
      expr = expr.subs(sym, realSym)
      replaced.append(realSym)
    self._variables = replaced

    # variables that appear only in the domains dict still participate
    names = [str(v) for v in self._variables]
    for symName in self._variableDomains:
      if symName not in names:
        self._variables.append(sy.Symbol(symName, real=True))

    self._probabilityDensityExpr = expr

  # ---------------------------------------------------------- analytic branch

  def _analyticTransform(self, varI):
    '''Symbolically build the inverse-CDF sampler for variable `varI`,
    marginalizing earlier variables and leaving later ones as parameters
    (reference: random_number_generator.py:204-320).'''
    expr = self._probabilityDensityExpr
    with _Timeout(self._deadline, getattr(self, '_wallDeadline', None)):
      # positivity sanity check (best effort)
      _noDelta = expr.replace(sy.DiracDelta, lambda *a: 0)
      isPositive = False
      try:
        isPositive = not bool(_noDelta < 0)
      except Exception:
        try:
          isPositive = not bool(sy.solve(_noDelta < 0))
        except Exception:
          pass
      if not isPositive:
        io.warn(f'cannot verify that probability density "{expr}" is '
                f'non-negative; negative probabilities lead to undefined '
                f'behavior')

      # marginalize out earlier variables over their full domains
      for i in range(varI):
        var = self._variables[i]
        l1, l2 = self._variableDomains.get(str(var), (-np.inf, np.inf))
        expr = sy.Integral(expr, (var, l1, l2)).doit()

      var = self._variables[varI]
      l1, l2 = self._variableDomains.get(str(var), (-np.inf, np.inf))
      varX = sy.Symbol('__x', real=True, **(dict(positive=True) if l1 >= 0
                                            else dict(negative=True) if l2 <= 0
                                            else {}))
      varY = sy.Symbol('__y', real=True, nonnegative=True)

      # Heaviside steps in the partial integral mark discrete events.
      # NOTE: use an assumption-free upper-limit symbol here — a
      # positivity assumption on __x silently simplifies Heaviside(__x)
      # away, zeroing the step height of a delta sitting at the domain edge
      varXe = sy.Symbol('__xe', real=True)
      fullPartial = sy.Integral(expr, (var, l1, varXe)).doit()
      eventVals = sorted({s for h in fullPartial.find(sy.Heaviside)
                          for s in sy.solve(h.args[0])
                          if s.is_real is not False})
      eps = 1e-13
      discreteVals, discreteProbs, trusted = [], [], []
      for val in eventVals:
        try:
          def stepHeight(deltaVal):
            repl = fullPartial.replace(sy.DiracDelta, lambda *a: deltaVal)
            return float((repl.subs(varXe, val + eps)
                          - repl.subs(varXe, val - eps)).evalf())
          zeroD, unitD = stepHeight(0), stepHeight(1)
          if zeroD < 0 or unitD < 0:
            raise ValueError('negative amplitude DiracDelta found in '
                             'probability density')
          discreteVals.append(float(val))
          discreteProbs.append(max(unitD, zeroD))
          trusted.append(math.isclose(unitD, zeroD, rel_tol=5 * eps, abs_tol=5 * eps))
        except TypeError:
          raise ValueError('can only combine DiracDelta with trivial '
                           'constant probability densities')

      # continuum part without steps/deltas
      smooth = (expr.replace(sy.Heaviside, lambda *a: 0)
                    .replace(sy.DiracDelta, lambda *a: 0))
      totalIntegral = sy.Integral(smooth, (var, l1, l2)).doit()
      partialIntegral = sy.Integral(smooth, (var, l1, varX)).doit()

      # normalize so discrete probabilities + continuum sum to one
      if discreteVals:
        smoothFull = (self._probabilityDensityExpr
                      .replace(sy.Heaviside, lambda *a: 0)
                      .replace(sy.DiracDelta, lambda *a: 0))
        continuumProb = float(sy.Integral(smoothFull, (var, l1, l2)).doit().evalf())
        totalProb = sum(p for p, t in zip(discreteProbs, trusted) if t) + continuumProb
        if totalProb:
          discreteProbs = [p / totalProb for p in discreteProbs]

      try:
        float(partialIntegral)
        # partial integral is constant -> no continuum part at all
        if not discreteVals:
          raise ValueError('random distribution has neither continuum nor '
                           'discrete part')
        inverses, exprYs = [], []
      except TypeError:
        exprYs = sy.solve(sy.Eq(partialIntegral / totalIntegral, varY), varX,
                          simplify=False)
        if not exprYs:
          raise ValueError(f'expression {partialIntegral/totalIntegral} '
                           f'seems not to be solvable for {varX}')
        inverses = [_lambdify([varY] + self._variables[varI + 1:], e)
                    for e in exprYs]

    return _AnalyticTransform(
        inverses, (l1, l2), discreteVals, discreteProbs,
        expressions=(expr / totalIntegral if totalIntegral != 0 else expr,
                     partialIntegral / totalIntegral if totalIntegral != 0
                     else partialIntegral,
                     exprYs))

  # ----------------------------------------------------------- numeric branch

  def _numericalResolution(self, var):
    if not self._numericalResolutions:
      self._numericalResolutions = 5 + int(1e6 ** (1 / len(self._variables)))
    if not isinstance(self._numericalResolutions, dict):
      self._numericalResolutions = {
          str(v): self._numericalResolutions for v in self._variables}
    # deviation from the reference (random_number_generator.py:323-331):
    # a PARTIAL resolutions dict there crashes with `round(None)`; here
    # variables missing from the dict fall back to the same default the
    # empty dict gets
    default = 5 + int(1e6 ** (1 / len(self._variables)))
    res = int(round(self._numericalResolutions.get(str(var), default)))
    return res + 1 if res % 2 == 0 else res

  def _numericTransform(self, varI, exprOverride=None):
    expr = self._probabilityDensityExpr if exprOverride is None else exprOverride
    for s in expr.free_symbols:
      if s not in self._variables:
        raise ValueError(f'probability density expression {expr} has free '
                         f'symbol {s} which is not in list of variables '
                         f'{self._variables}')
    ranges, inBetween = [], []
    for var in self._variables:
      l1, l2 = self._variableDomains.get(str(var), (-np.inf, np.inf))
      if not np.isfinite(l1) or not np.isfinite(l2):
        raise ValueError(f'failed to find analytical solution, numerical '
                         f'solution requires finite limits, but found limits '
                         f'[{l1}, {l2}] for variable {var}')
      r = np.linspace(l1, l2, self._numericalResolution(var))
      ranges.append(r)
      inBetween.append((r[1:] + r[:-1]) / 2)
    grids = np.meshgrid(*inBetween, indexing='ij')
    lam = _lambdify(self._variables, expr)
    gridProbs = lam(*grids)
    return self._transformFromSampled(gridProbs, varI, ranges, inBetween,
                                      expr=expr)

  def _transformFromSampled(self, gridProbs, varI, ranges, inBetween,
                            expr=None):
    '''Build a _NumericTransform from PDF values tabulated on the ij-indexed
    meshgrid of the in-between grids (reference semantics of
    random_number_generator.py:372-464, re-laid-out as (rows=later-vars,
    cols=this-var) conditional CDF tables).'''
    shape = tuple(len(g) for g in inBetween)
    gridProbs = np.broadcast_to(np.asarray(gridProbs, dtype=float), shape).copy()
    if (gridProbs < 0).any():
      raise ValueError(f'found negative probability density, expression: '
                       f'{expr}, variable: {self._variables[varI]}')
    # warn about poorly resolved densities
    scale = gridProbs.max() - gridProbs.min()
    if scale < 1e-10:
      scale = 1
    for dim in range(gridProbs.ndim):
      diff = np.abs(np.diff(gridProbs, axis=dim))
      if diff.size and diff.max() / scale > self._warnIfDiscretizationStepAbove:
        io.warn(f'numerical evaluation of probability density expression '
                f'{self._probabilityDensityExpr} had jumps larger than '
                f'{1e2*self._warnIfDiscretizationStepAbove:.1f}%')
        break

    # marginalize out earlier variables, keep later ones as conditions
    marg = gridProbs.sum(axis=tuple(range(varI))) if varI else gridProbs
    # axes of marg: (varI, varI+1, ..., k) -> move this var's axis last
    marg = np.moveaxis(marg, 0, -1)
    cdf = np.concatenate([np.zeros(marg.shape[:-1] + (1,)),
                          np.cumsum(marg, axis=-1)], axis=-1)
    last = cdf[..., -1:]
    with np.errstate(invalid='ignore', divide='ignore'):
      cdf = np.where(last > 0, cdf / np.where(last > 0, last, 1), np.nan)
    cdf = cdf.reshape(-1, cdf.shape[-1])
    return _NumericTransform(values=ranges[varI], cdf=cdf,
                             laterGrids=inBetween[varI + 1:],
                             domain=(ranges[varI][0], ranges[varI][-1]))

  # ----------------------------------------------------------------- sampling

  def draw(self, N=None, constants=None, rng=None, _noVarOrderCheck=False):
    '''
    Draw samples following the compiled distribution: the last variable is
    drawn from its marginal, earlier variables conditioned on the drawn later
    ones (reference: random_number_generator.py:467-560). Returns a dict
    {varname: values} when no variableOrder was given, else an array whose
    first axis follows variableOrder.
    '''
    if self._transforms is None or (constants is not None
                                    and constants != self._constantsDict):
      self.compile(**(constants or {}))
    rng = rng or _DEFAULT_RNG
    n = None if N is None else max(1, int(round(N)))

    drawn = []  # values for variables k, k-1, ..., down to 0
    for i in reversed(range(len(self._variables))):
      transform = self._transforms[i]
      u = rng.random(() if n is None else n)
      laterValues = drawn[::-1]  # ascending variable order i+1..k
      vals = transform(np.atleast_1d(u),
                       [np.atleast_1d(v) for v in laterValues], rng)
      l1, l2 = self._variableDomains.get(str(self._variables[i]),
                                         (-np.inf, np.inf))
      outside = ~((l1 <= vals) & (vals <= l2))
      if transform.kind == 'analytic' and np.any(outside & ~np.isnan(vals)):
        raise ValueError('no/more than one valid value found in domain')
      drawn.append(vals if n is not None else vals[0])

    result = np.array(drawn[::-1])
    if self._variableOrder is None:
      return {str(k): v for k, v in zip(self._variables, result)}

    names = [str(v) for v in self._variables]
    if not _noVarOrderCheck:
      remaining = list(names)
      for v in self._variableOrder:
        if v not in remaining:
          raise ValueError(f'variable {v} is given in variable ordering, but '
                           f'does not seem to exist in expression '
                           f'{self._probabilityDensityExpr}')
        remaining.remove(v)
      if remaining:
        raise ValueError(f'variables {remaining} exist in expression '
                         f'{self._probabilityDensityExpr} but do not exist '
                         f'in {self._variableOrder}; are all constants '
                         f'specified?')
    order = [names.index(v) for v in self._variableOrder]
    return result[order]

  def drawPseudo(self, N, bins=None, overdrawFactor=0.1, overdrawIterations=50,
                 constants=None, rng=None):
    '''
    Low-discrepancy draw: same conditional inverse transforms as draw(), but
    fed with independently shuffled stratified quantiles (latin hypercube).
    Every marginal's per-bin histogram error is bounded at ±1 sample, which
    meets the reference's "pseudo random" histogram-matching intent
    (reference: random_number_generator.py:562-682) without its sequential
    overdraw-and-trim loop. `bins`/`overdrawFactor`/`overdrawIterations` are
    accepted for signature parity and ignored.
    '''
    if N <= 1:
      raise ValueError('N must be greater than one in pseudo random mode')
    if not self._variableOrder:
      raise ValueError('variableOrder must be passed to constructor to use '
                       'pseudo random mode.')
    if self._transforms is None or (constants is not None
                                    and constants != self._constantsDict):
      self.compile(**(constants or {}))
    rng = rng or _DEFAULT_RNG
    n = max(2, int(round(N)))

    drawn = []
    for i in reversed(range(len(self._variables))):
      transform = self._transforms[i]
      u = rng.permutation((np.arange(n) + rng.random(n)) / n)
      laterValues = drawn[::-1]
      vals = transform(u, [np.atleast_1d(v) for v in laterValues], rng)
      drawn.append(vals)

    result = np.array(drawn[::-1])
    names = [str(v) for v in self._variables]
    order = [names.index(v) for v in self._variableOrder if v in names]
    return result[order]

  def findGrid(self, N, startFrom=None, constants=None):
    '''Deterministic 1-D grid whose local point density follows the PDF
    (reference: random_number_generator.py:685-725).'''
    if self._transforms is None or (constants is not None
                                    and constants != self._constantsDict):
      self.compile(**(constants or {}))
    if len(self._variables) != 1:
      raise RuntimeError('grid generation is not implemented for variable '
                         'count greater than 1')
    var = self._variables[0]
    l1, l2 = self._variableDomains.get(str(var), (-np.inf, np.inf))
    if not np.isfinite(l1) or not np.isfinite(l2):
      raise ValueError('variable domains must be finite for grid generation')
    varRange = np.linspace(l1, l2, self._numericalResolution(var))
    lam = _lambdify([var], self._probabilityDensityExpr)
    density = np.broadcast_to(np.asarray(lam(varRange), dtype=float),
                              varRange.shape)
    if startFrom is None:
      startFrom = varRange[np.argmax(density)]
    result = points_by_density.generatePointsWithGivenDensity1D(
        density=(varRange, density), N=N, startFrom=startFrom)
    return result[(varRange.min() <= result) & (result <= varRange.max())]

  # -------------------------------------------------------------- device path

  def deviceTables(self):
    '''
    Export the sampler as tabulated conditional inverse-CDF tables for
    on-device (jit/vmap) sampling — see
    distributions.device_sampler.DeviceSampler. Requires finite domains.
    Discrete (DiracDelta) events are included as per-variable value/prob
    tables.
    '''
    from .device_sampler import buildDeviceTables
    return buildDeviceTables(self)


class ScalarRandomVariable(VectorRandomVariable):
  '''One-variable wrapper (reference: random_number_generator.py:729-769).'''

  def __init__(self, probabilityDensity, variableDomain, variable=None,
               numericalResolution=None, **kwargs):
    self._desiredVariable = variable
    if variable is None:
      variable = str(list(sy.sympify(probabilityDensity).free_symbols)[0])
    super().__init__(
        probabilityDensity,
        variableDomains={variable: variableDomain},
        numericalResolutions={} if numericalResolution is None
        else {variable: numericalResolution},
        variableOrder=[variable],
        **kwargs)

  def compile(self, **kwargs):
    def _checkScalarity():
      freeSymbols = sy.sympify(self._probabilityDensityExpr).free_symbols
      if (len(freeSymbols) and self._desiredVariable is not None
          and self._desiredVariable not in [str(s) for s in freeSymbols]):
        raise ValueError(f'specified variable "{self._desiredVariable}" does '
                         f'not seem to appear in expression '
                         f'"{self._probabilityDensityExpr}"')
      if len(self._variables) > 1:
        raise ValueError(f'expression "{self._probabilityDensityExpr}" seems '
                         f'to have more than one free variable after '
                         f'substituting constants; did you pass all constants '
                         f'to .compile() or .draw()?')
    try:
      super().compile(**kwargs)
    except ValueError as e:
      if 'requires finite limits' in str(e):
        _checkScalarity()
      raise
    _checkScalarity()

  def draw(self, N=None, **kwargs):
    return super().draw(N=N, **kwargs)[0]


class SampledVectorRandomVariable(VectorRandomVariable):
  '''Random variable built from tabulated `(variableRanges, gridProbs)`
  instead of a symbolic expression — used e.g. for surface UV sampling
  (reference: random_number_generator.py:772-802). `gridProbs` is indexed
  `gridProbs[i_0, i_1, ...]` over the in-between points of variableRanges
  in order (ij indexing).'''

  def __init__(self, variableRanges, gridProbs, **kwargs):
    super().__init__('1', **kwargs)
    self._probabilityDensityExpr = sy.sympify('1')
    self._inBetween = [np.asarray(r, dtype=float) for r in variableRanges]
    self._ranges = [np.concatenate([
        [r[0] - (r[1] - r[0]) / 2],
        (r[:-1] + r[1:]) / 2,
        [r[-1] + (r[-1] - r[-2]) / 2]]) for r in self._inBetween]
    self._gridProbs = np.asarray(gridProbs, dtype=float)
    letters = 'abcdefghijklmnopqrstuvw'
    self._variables = [sy.Symbol(letters[i], real=True)
                       for i in range(len(variableRanges))]
    self._variableOrder = [str(v) for v in self._variables]
    for v, r in zip(self._variables, self._ranges):
      self._variableDomains[str(v)] = (r[0], r[-1])

  def compile(self, **kwargs):
    self._transforms = [
        self._transformFromSampled(self._gridProbs, i, self._ranges,
                                   self._inBetween)
        for i in range(len(self._variables))]
    self._mode = 'numeric'
    self._needsRecompile = False

  def draw(self, *args, **kwargs):
    if self._transforms is None:
      self.compile()
    return super().draw(*args, **kwargs, _noVarOrderCheck=True)
