'''The device path a GPU run takes, checked on the CPU: with jax reporting a
'gpu' backend, runSimulation (histogram mode), evaluateBatched and
makeBenchStep must all build the one XLA fused step; and the two pieces
of it chosen by measurement on the GPU — scatter-add binning and the
gather-lerp inverse-CDF sampler — must match numpy's own histogram2d and
interp.
'''

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optics_design_workbench import benchmarks
from optics_design_workbench.tracing import fused


@pytest.fixture
def gpuBackend(monkeypatch):
  monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')


@pytest.fixture
def fusedSpy(monkeypatch):
  calls = []
  real = fused.makeFusedStep

  def spy(*args, **kwargs):
    calls.append(kwargs.get('raysPerStep'))
    return real(*args, **kwargs)
  monkeypatch.setattr(fused, 'makeFusedStep', spy)
  return calls


def test_make_bench_step_takes_fused_step_on_gpu(gpuBackend, fusedSpy):
  step, hist, meta = benchmarks.makeBenchStep(raysPerStep=1024,
                                              maxIntersections=4,
                                              bins=(16, 16))
  hist, counters = step(jax.random.PRNGKey(0), hist)
  assert fusedSpy == [1024]
  assert int(counters['hits']) > 0.9 * 1024


def test_run_simulation_histogram_mode_takes_fused_step_on_gpu(
    tmp_path, gpuBackend, fusedSpy):
  from optics_design_workbench import simulation
  from optics_design_workbench.simulation import results_store
  scene = benchmarks.buildLensMirrorScene(tmpdir=str(tmp_path))
  s = scene.activeSimulationSettings()
  s.RaysPerIteration, s.EndAfterRays = 2048, 8192
  runPath = simulation.runSimulation(scene, 'true', seed=1,
                                     recording='histogram',
                                     histBins=(16, 16))
  assert fusedSpy == [2048]
  hists = results_store.loadHistogramSnapshots(runPath)
  counts = hists['Source']['Detector']['counts']
  assert counts.sum() > 0.9 * 8192


def test_evaluate_batched_takes_xla_sweep_step_on_gpu(gpuBackend,
                                                      monkeypatch):
  from optics_design_workbench.jupyter_utils import (ParameterSweeper,
                                                     Parameter)
  from optics_design_workbench.jupyter_utils import parameter_sweeper as PS
  built = []
  real = PS._makeBatchedSweepStep

  def spy(*args, **kwargs):
    built.append(args)
    return real(*args, **kwargs)
  monkeypatch.setattr(PS, '_makeBatchedSweepStep', spy)
  holder = dict(R=60.)

  def factory():
    from optics_design_workbench.geometry import transforms as T
    scene = benchmarks.buildSourceDetectorScene()
    g = scene.getObject('Detector')
    g.placements = [T.translation(0, 0, holder['R'])]
    return scene

  sweeper = ParameterSweeper(
      lambda sc: dict(R=Parameter(getter=lambda: holder['R'],
                                  setter=lambda v: holder.update(R=v))),
      scene=factory())
  out = sweeper.evaluateBatched(
      [dict(R=r) for r in (60., 100., 140.)],
      lambda power, counts: float(counts.sum()), sceneFactory=factory,
      raysPerScene=512, maxIntersections=2, bins=(8, 8),
      histBounds=(-60., 60., -60., 60.))
  assert len(built) == 1
  assert out.shape == (3,) and (out > 0).all()
  assert out[0] >= out[2]          # the farther detector catches fewer rays


@pytest.mark.parametrize('D,H,W,n', [
    (1, 8, 8, 100), (1, 16, 32, 5000), (2, 32, 16, 4096),
    (3, 1, 64, 777), (1, 128, 128, 20000), (4, 5, 7, 2500),
    (2, 64, 1, 1000), (1, 3, 3, 1)])
def test_bin_hits_matches_histogram2d(D, H, W, n):
  rng = np.random.default_rng(D * 1000 + H + W + n)
  bounds = np.stack([rng.uniform(-50, -10, D), rng.uniform(10, 50, D),
                     rng.uniform(-50, -10, D), rng.uniform(10, 50, D)],
                    axis=1).astype(np.float32)
  det = rng.integers(-1, D, n).astype(np.int32)
  valid = rng.random(n) < 0.9
  x = rng.uniform(-60, 60, n).astype(np.float32)
  y = rng.uniform(-60, 60, n).astype(np.float32)
  power = rng.uniform(0, 2, n).astype(np.float32)
  hist0 = dict(power=jnp.ones((D, H, W)), counts=jnp.zeros((D, H, W)))
  hist, binned = jax.jit(fused.binHits, static_argnames='bins')(
      hist0, jnp.asarray(det), jnp.asarray(valid), jnp.asarray(x),
      jnp.asarray(y), jnp.asarray(power), jnp.asarray(bounds), bins=(H, W))
  total = 0
  for d in range(D):
    m = valid & (det == d)
    x0, x1, y0, y1 = bounds[d].astype(np.float64)
    # np.histogram2d closes the last bin; the device bins are half-open
    keep = m & (x < x1) & (y < y1)
    c, _, _ = np.histogram2d(y[keep], x[keep], bins=(H, W),
                             range=((y0, y1), (x0, x1)))
    p, _, _ = np.histogram2d(y[keep], x[keep], bins=(H, W),
                             range=((y0, y1), (x0, x1)),
                             weights=power[keep])
    np.testing.assert_array_equal(np.asarray(hist['counts'][d]), c)
    np.testing.assert_allclose(np.asarray(hist['power'][d]), p + 1.,
                               rtol=1e-5, atol=1e-5)
    total += int(c.sum())
  assert int(binned) == total


@pytest.mark.parametrize('rows,Q,seed', [
    (1, 2, 0), (1, 17, 1), (1, 4097, 2), (3, 65, 3), (8, 257, 4),
    (2, 1025, 5)])
def test_inverse_cdf_lerp_matches_np_interp(rows, Q, seed):
  from optics_design_workbench.distributions.device_sampler import \
      lerpInverseCdf
  rng = np.random.default_rng(seed)
  inv = np.sort(rng.uniform(-3, 5, (rows, Q)), axis=1).astype(np.float32)
  pairs = np.stack([inv[:, :-1], inv[:, 1:]], axis=-1).reshape(-1, 2)
  n = 3000
  u = np.concatenate([rng.random(n - 3), [0., 1., 0.5]]).astype(np.float32)
  r = rng.integers(0, rows, n).astype(np.int32)
  got = np.asarray(lerpInverseCdf(jnp.asarray(pairs), jnp.asarray(u), Q,
                                  jnp.asarray(r) if rows > 1 else None))
  q = np.linspace(0., 1., Q)
  want = np.array([np.interp(ui, q, inv[ri if rows > 1 else 0])
                   for ui, ri in zip(u.astype(np.float64), r)])
  np.testing.assert_allclose(got, want, rtol=2e-6,
                             atol=2e-6 * np.abs(inv).max())


@pytest.mark.gpu
def test_fused_step_on_gpu_matches_cpu(gpu):
  '''On a GPU machine: the bench step, same key, on the card and on the
  CPU — the check of chip_smoke.py phase 2 at a test size.'''
  out = {}
  for dev in (gpu, jax.devices('cpu')[0]):
    with jax.default_device(dev):
      step, hist, _ = benchmarks.makeBenchStep(raysPerStep=1 << 16,
                                               maxIntersections=6,
                                               bins=(64, 64))
      hist, counters = step(jax.random.PRNGKey(7), hist)
      out[dev.platform] = (np.asarray(hist['counts']), int(counters['hits']))
  (cG, hG), (cC, hC) = out['gpu'], out['cpu']
  assert abs(hG - hC) <= 1e-4 * hC + 2
  assert np.abs(cG - cC).sum() <= 1e-3 * cC.sum() + 4
