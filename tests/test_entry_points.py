'''Entry points that must fail loudly instead of falling back: chip_smoke.py
without a GPU (or outside a checkout), bench.py when its step raises; and
where the persistent compilation cache goes with and without
JAX_COMPILATION_CACHE_DIR.'''

import os
import shutil
import subprocess
import sys

import jax
import pytest

import optics_design_workbench
from optics_design_workbench import compilationCacheDir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
  env = {k: v for k, v in os.environ.items()
         if k not in ('JAX_COMPILATION_CACHE_DIR', 'PYTHONPATH')}
  env['JAX_PLATFORMS'] = 'cpu'
  env.update(extra)
  return env


def _run(args, cwd=REPO, **extra):
  return subprocess.run([sys.executable] + args, cwd=cwd, env=_env(**extra),
                        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('where', ['checkout', 'bare_directory'])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
  cwd = REPO
  if where == 'bare_directory':
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    cwd = str(tmp_path)
  proc = _run(['chip_smoke.py'], cwd=cwd)
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout
  assert proc.stdout.strip() == ''


@pytest.mark.parametrize('args,phases', [
    ([], ['phase 0 environment', 'phase 1 compile', 'phase 2 gpu-vs-cpu',
          'phase 3 per-ray oracle', 'phase 4 histogram run',
          'phase 4 surface-source run', 'phase 4 raw run',
          'phase 4 batched sweep']),
    (['--four'], ['phase 0 environment', 'four runSimulation',
                  'four sharded-vs-per-shard'])], ids=['one_device', 'four'])
def test_chip_smoke_cpu_rehearsal_passes_every_phase(args, phases):
  '''The rehearsal runs every phase's control flow and checks on the CPU at
  1/1024 of the sizes; its last line is never the ok line.'''
  proc = _run(['chip_smoke.py', '--cpu-rehearsal'] + args)
  assert proc.returncode == 0, proc.stderr[-3000:]
  lines = proc.stdout.strip().splitlines()
  assert [l[1:].split(']')[0] for l in lines if l.startswith('[')] == phases
  assert lines[-1] == '{"rehearsal": true, "platform": "cpu"}'
  assert '"ok"' not in proc.stdout


def test_bench_exits_nonzero_when_step_raises():
  code = (
      'import runpy\n'
      'from optics_design_workbench import benchmarks\n'
      'def boom(*a, **k):\n'
      '  raise RuntimeError("step failed")\n'
      'benchmarks.makeBenchStep = boom\n'
      "runpy.run_path('bench.py', run_name='__main__')\n")
  proc = _run(['-c', code], PYTHONPATH=REPO)
  assert proc.returncode != 0
  assert 'step failed' in proc.stderr
  assert proc.stdout.strip() == ''


_PRINT_CACHE_DIR = ('import optics_design_workbench, jax; '
                    'print(jax.config.jax_compilation_cache_dir)')


def test_package_cache_dir_defaults_to_checkout():
  proc = _run(['-c', _PRINT_CACHE_DIR], PYTHONPATH=REPO)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == os.path.join(REPO, '.jax_cache')


def test_package_cache_dir_follows_environment(tmp_path):
  proc = _run(['-c', _PRINT_CACHE_DIR], PYTHONPATH=REPO,
              JAX_COMPILATION_CACHE_DIR=str(tmp_path))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == str(tmp_path)


def test_cache_dir_helper(monkeypatch, tmp_path):
  monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
  fixed = compilationCacheDir()
  assert fixed == os.path.join(
      os.path.dirname(os.path.dirname(
          os.path.abspath(optics_design_workbench.__file__))), '.jax_cache')
  assert os.path.basename(fixed) == '.jax_cache'   # no digest, pid or time
  monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
  assert compilationCacheDir() == str(tmp_path)


def test_tests_use_the_one_cache_dir():
  assert jax.config.jax_compilation_cache_dir == (
      os.environ.get('JAX_COMPILATION_CACHE_DIR') or compilationCacheDir())
