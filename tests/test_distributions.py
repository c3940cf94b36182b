'''
Quantitative sampler tests, mirroring the reference's CI-enforced thresholds
(reference: test/10-pure-python-notebooks/distributions_quantitative.ipynb):
1-D RMS histogram error < 3e-2 at N=1e6, 2-D < 0.1, DiracDelta mixtures,
variable order, numeric fallback detection.
'''

import numpy as np
import pytest
import jax

from optics_design_workbench import distributions
from optics_design_workbench.distributions import (
                                                   VectorRandomVariable, ScalarRandomVariable, SampledVectorRandomVariable,
                                                   buildDeviceTables, deviceDraw)


def _rmsHistError1D(samples, pdf, domain, bins=50):
  lo, hi = domain
  hist, edges = np.histogram(samples, bins=bins, range=(lo, hi), density=True)
  centers = (edges[1:] + edges[:-1]) / 2
  binWidth = edges[1] - edges[0]
  expected = pdf(centers)
  expected = expected / (expected.sum() * binWidth)
  scale = expected.max()
  return np.sqrt(np.mean(((hist - expected) / scale) ** 2))


N = 1_000_000


class TestScalar1D:

  @pytest.mark.parametrize('expr,pdf,domain,mode', [
      ('exp(-x**2/0.1)', lambda x: np.exp(-x**2 / 0.1), (-1, 1), 'analytic'),
      ('1', lambda x: np.ones_like(x), (0, 2), 'analytic'),
      ('sin(x)**2', lambda x: np.sin(x)**2, (0, np.pi), None),
      ('exp(-(x-0.3)**2/0.05)*(2+sin(5*x))',
       lambda x: np.exp(-(x - 0.3)**2 / 0.05) * (2 + np.sin(5 * x)),
       (-1, 1), 'numeric'),
  ])
  def test_histogram_matches_pdf(self, expr, pdf, domain, mode):
    rv = ScalarRandomVariable(expr, variableDomain=domain, variable='x',
                              numericalResolution=10001)
    rv.compile()
    if mode is not None:
      assert rv.mode() == mode
    samples = rv.draw(N=N)
    assert samples.shape == (N,)
    assert np.all((domain[0] <= samples) & (samples <= domain[1]))
    assert _rmsHistError1D(samples, pdf, domain) < 3e-2

  def test_pseudo_beats_true_random(self):
    rv = ScalarRandomVariable('exp(-x**2/0.1)', variableDomain=(-1, 1),
                              numericalResolution=10001)
    pdf = lambda x: np.exp(-x**2 / 0.1)
    n = 20000
    errTrue = np.median([_rmsHistError1D(rv.draw(N=n), pdf, (-1, 1))
                         for _ in range(3)])
    errPseudo = np.median([_rmsHistError1D(rv.drawPseudo(N=n), pdf, (-1, 1))
                           for _ in range(3)])
    assert errPseudo < errTrue

  def test_find_grid_density(self):
    rv = ScalarRandomVariable('exp(-x**2/0.02)', variableDomain=(-1, 1),
                              numericalResolution=20001)
    grid = rv.findGrid(N=2001)
    assert len(grid) == 2001
    assert grid[0] == -1 and grid[-1] == 1
    # local density of the grid ~ pdf: inverse spacing at 0 should exceed
    # inverse spacing at +-0.8 by roughly pdf ratio
    mid = np.argmin(np.abs(grid))
    d0 = grid[mid + 1] - grid[mid]
    edge = np.clip(np.argmin(np.abs(grid - 0.3)), 0, len(grid) - 2)
    d3 = grid[edge + 1] - grid[edge]
    ratio = d3 / d0
    expected = np.exp(-0**2 / 0.02) / np.exp(-0.3**2 / 0.02)
    assert 0.5 * expected < ratio < 2 * expected


class TestVector2D:

  def test_separable_gaussian(self):
    rv = VectorRandomVariable('exp(-theta**2/0.01)*abs(sin(theta))',
                              variableDomains=dict(theta=(0, np.pi / 4),
                                                   phi=(0, 2 * np.pi)),
                              numericalResolutions=dict(theta=10001, phi=101),
                              variableOrder=('theta', 'phi'))
    rv.compile()
    theta, phi = rv.draw(N=N)
    pdfT = lambda t: np.exp(-t**2 / 0.01) * np.abs(np.sin(t))
    assert _rmsHistError1D(theta, pdfT, (0, np.pi / 4)) < 3e-2
    assert _rmsHistError1D(phi, lambda p: np.ones_like(p), (0, 2 * np.pi)) < 3e-2

  def test_partial_resolutions_dict_defaults(self):
    '''A resolutions dict covering only SOME variables must default the
    missing ones instead of crashing (the reference raises TypeError via
    round(None), random_number_generator.py:331 — documented deviation).'''
    rv = VectorRandomVariable('exp(-theta**2/0.1)*abs(sin(theta))',
                              variableDomains=dict(theta=(0., 1.2),
                                                   phi=(0., 2 * np.pi)),
                              numericalResolutions=dict(theta=2001),
                              variableOrder=('theta', 'phi'))
    rv.compile()
    theta, phi = np.asarray(rv.draw(N=N))
    assert 0.05 < theta.mean() < 0.6
    assert abs(phi.mean() - np.pi) < 0.1

  def test_correlated_2d(self):
    # astigmatic gaussian: theta spread depends on phi
    expr = 'exp(-(theta*cos(phi))**2/0.01 - (theta*sin(phi))**2/0.04)'
    rv = VectorRandomVariable(expr,
                              variableDomains=dict(theta=(0, 0.8),
                                                   phi=(0, 2 * np.pi)),
                              numericalResolutions=dict(theta=2001, phi=201),
                              variableOrder=('theta', 'phi'))
    rv.compile()
    theta, phi = rv.draw(N=N)
    # 2-D histogram RMS error < 0.1 (reference threshold)
    H, te, pe = np.histogram2d(theta, phi, bins=[20, 20],
                               range=[[0, 0.8], [0, 2 * np.pi]])
    tc, pc = (te[1:] + te[:-1]) / 2, (pe[1:] + pe[:-1]) / 2
    T, P = np.meshgrid(tc, pc, indexing='ij')
    expected = np.exp(-(T * np.cos(P))**2 / 0.01 - (T * np.sin(P))**2 / 0.04)
    expected /= expected.sum()
    Hn = H / H.sum()
    rms = np.sqrt(np.mean(((Hn - expected) / expected.max()) ** 2))
    assert rms < 0.1
    # conditional structure: theta spread at phi~pi/2 wider than at phi~0
    sel0 = np.abs(((phi + np.pi / 8) % np.pi) - np.pi / 8) < np.pi / 16
    sel90 = np.abs(phi % np.pi - np.pi / 2) < np.pi / 16
    assert theta[sel90].std() > 1.5 * theta[sel0].std()


class TestDiracDelta:

  def test_pure_discrete(self):
    rv = ScalarRandomVariable('DiracDelta(x-0.25) + 3*DiracDelta(x-0.75)',
                              variableDomain=(0, 1))
    rv.compile()
    assert rv.mode() == 'analytic'
    s = rv.draw(N=100000)
    frac25 = np.mean(np.isclose(s, 0.25))
    frac75 = np.mean(np.isclose(s, 0.75))
    assert abs(frac25 - 0.25) < 0.02
    assert abs(frac75 - 0.75) < 0.02

  def test_mixture_with_continuum(self):
    rv = ScalarRandomVariable('DiracDelta(x-0.5) + 1', variableDomain=(0, 1))
    rv.compile()
    s = rv.draw(N=100000)
    atDelta = np.isclose(s, 0.5, atol=1e-9)
    # P(delta) = 1/(1+1) = 0.5
    assert abs(np.mean(atDelta) - 0.5) < 0.02
    cont = s[~atDelta]
    assert _rmsHistError1D(cont, lambda x: np.ones_like(x), (0, 1)) < 5e-2

  def test_numeric_mode_rejects_delta(self):
    rv = ScalarRandomVariable('DiracDelta(x-0.5)*x**2', variableDomain=(0, 1))
    with pytest.raises(ValueError):
      rv.compile(disableAnalytical=True)
      rv.draw(N=10)


class TestSampledVRV:

  def test_tabulated_2d(self):
    u = np.linspace(0, 1, 51)
    v = np.linspace(0, 2, 101)
    U, V = np.meshgrid(u, v, indexing='ij')
    probs = U + 0 * V  # density rises linearly with u, uniform in v
    rv = SampledVectorRandomVariable(variableRanges=[u, v], gridProbs=probs)
    a, b = rv.draw(N=200000)
    assert _rmsHistError1D(a, lambda x: x, (0, 1), bins=20) < 5e-2
    assert _rmsHistError1D(b, lambda x: np.ones_like(x), (0, 2), bins=20) < 5e-2


class TestDeviceSampler:

  def test_device_matches_host(self):
    rv = VectorRandomVariable('exp(-theta**2/0.01)*abs(sin(theta))',
                              variableDomains=dict(theta=(0, np.pi / 4),
                                                   phi=(0, 2 * np.pi)),
                              numericalResolutions=dict(theta=5001, phi=101),
                              variableOrder=('theta', 'phi'))
    rv.compile()
    tables = buildDeviceTables(rv)
    key = jax.random.PRNGKey(0)
    out = jax.jit(lambda k: deviceDraw(tables, k, 200000))(key)
    theta, phi = np.asarray(out)
    pdfT = lambda t: np.exp(-t**2 / 0.01) * np.abs(np.sin(t))
    assert _rmsHistError1D(theta, pdfT, (0, np.pi / 4)) < 3e-2
    assert _rmsHistError1D(phi, lambda p: np.ones_like(p), (0, 2 * np.pi)) < 5e-2

  def test_device_stratified(self):
    rv = ScalarRandomVariable('exp(-x**2/0.1)', variableDomain=(-1, 1),
                              numericalResolution=5001)
    rv.compile()
    tables = buildDeviceTables(rv)
    pdf = lambda x: np.exp(-x**2 / 0.1)
    key = jax.random.PRNGKey(1)
    iid = np.asarray(deviceDraw(tables, key, 20000))[0]
    strat = np.asarray(deviceDraw(tables, key, 20000, stratified=True))[0]
    assert (_rmsHistError1D(strat, pdf, (-1, 1))
            < _rmsHistError1D(iid, pdf, (-1, 1)))

  def test_device_discrete(self):
    rv = ScalarRandomVariable('DiracDelta(x-0.25) + 3*DiracDelta(x-0.75)',
                              variableDomain=(0, 1))
    rv.compile()
    tables = buildDeviceTables(rv)
    s = np.asarray(deviceDraw(tables, jax.random.PRNGKey(2), 100000))[0]
    assert abs(np.mean(np.isclose(s, 0.25, atol=1e-5)) - 0.25) < 0.02
    assert abs(np.mean(np.isclose(s, 0.75, atol=1e-5)) - 0.75) < 0.02


def test_variable_order_respected():
  rv = VectorRandomVariable('exp(-a**2) * exp(-(b-3)**2)',
                            variableDomains=dict(a=(-3, 3), b=(0, 6)),
                            variableOrder=('b', 'a'))
  rv.compile()
  b, a = rv.draw(N=10000)
  assert abs(np.mean(b) - 3) < 0.1
  assert abs(np.mean(a)) < 0.1


def test_draw_without_order_returns_dict():
  rv = VectorRandomVariable('exp(-q**2)', variableDomains=dict(q=(-3, 3)))
  rv.compile()
  out = rv.draw(N=100)
  assert isinstance(out, dict) and 'q' in out and out['q'].shape == (100,)


def test_constants_recompile():
  rv = ScalarRandomVariable('exp(-(x-mu)**2/0.01)', variable='x',
                            variableDomain=(-2, 2))
  rv.compile(mu=1.0)
  s1 = rv.draw(N=10000)
  assert abs(np.mean(s1) - 1.0) < 0.05
  rv.compile(mu=-1.0)
  s2 = rv.draw(N=10000)
  assert abs(np.mean(s2) + 1.0) < 0.05


def test_points_by_density():
  from optics_design_workbench.distributions.points_by_density import (
                                                                       generatePointsWithGivenDensity1D)
  x = np.linspace(0, 1, 1001)
  y = 1 + 10 * x
  pts = generatePointsWithGivenDensity1D((x, y), N=101)
  assert len(pts) == 101
  assert pts[0] == 0 and pts[-1] == 1
  spacingLow = np.diff(pts[:10]).mean()
  spacingHigh = np.diff(pts[-10:]).mean()
  assert spacingLow > 3 * spacingHigh
