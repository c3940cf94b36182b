import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
# exercised without a GPU. Tests that need the card take the `gpu` fixture
# (and carry the `gpu` marker); on a GPU machine run them with
#   ODW_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
  os.environ['XLA_FLAGS'] = (
      flags + ' --xla_force_host_platform_device_count=8').strip()

import numpy as np
import pytest

import jax
ON_GPU = bool(os.environ.get('ODW_TESTS_ON_GPU'))
if not ON_GPU:
  jax.config.update('jax_platforms', 'cpu')

# persistent compilation cache: the trace/scan programs are expensive to
# compile on the CPU test backend, so they are cached across test runs in
# the package's one cache directory (when JAX_COMPILATION_CACHE_DIR is set,
# jax reads it itself and nothing is configured here)
from optics_design_workbench import compilationCacheDir
if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
  jax.config.update('jax_compilation_cache_dir', compilationCacheDir())
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)

if not ON_GPU:
  assert jax.devices()[0].platform == 'cpu' and len(jax.devices()) == 8, \
      'tests must run on the virtual 8-device CPU mesh'


@pytest.fixture
def gpu():
  '''The first GPU device; skips the test when there is none. Decided when
  the test runs, never at import or collection time, so every xdist worker
  collects the same tests.'''
  try:
    devices = jax.devices('gpu')
  except RuntimeError:
    devices = []
  if not devices:
    pytest.skip('needs an NVIDIA GPU (run with ODW_TESTS_ON_GPU=1 on a '
                'GPU machine)')
  return devices[0]


@pytest.fixture(autouse=True)
def _seed():
  from optics_design_workbench import distributions
  distributions.setGlobalSeed(12345)
  np.random.seed(12345)
  yield
