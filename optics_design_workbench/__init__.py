'''
optics_design_workbench — a JAX optics ray-tracing framework.

A JAX/XLA re-design of the capabilities of the FreeCAD
"Optics Design Workbench" (reference: zaphB/freecad.optics_design_workbench):
physically accurate forward ray tracing of CAD-defined optical assemblies with

  * point / surface / replay light sources whose ray directions and positions
    are sampled from arbitrary user-supplied symbolic power-density
    expressions (reference: distributions/random_number_generator.py),
  * mirror / lens / grating / absorber / vacuum-detector optical elements with
    Snell refraction + total internal reflection, specular and stochastic
    scattering, Ludwig-1970 grating diffraction and Beer-Lambert absorption
    (reference: freecad_elements/ray.py, optical_group.py),
  * deterministic ray-fan and Monte-Carlo simulation modes with the same
    on-disk results contract (`<name>.OpticsDesign/raw/simulation-run-N/...`)
    and the same Jupyter analysis/optimization workflow
    (reference: simulation/results_store.py, jupyter_utils/).

Unlike the reference — a per-ray Python loop calling FreeCAD's OpenCASCADE
C++ kernel — this framework compiles the scene to device arrays of analytic
surfaces, traces batches of millions of rays with a `jax.lax.scan` bounce
loop over vmapped closed-form intersection kernels, samples sources with
`jax.random` through pre-tabulated inverse-CDF tables, records hits with
on-device scatter-adds, and shards the ray axis across devices with
`jax.sharding`/`shard_map`. Its device path runs on NVIDIA GPUs (and on
the CPU for tests).
'''

__version__ = '0.1.0'


def compilationCacheDir():
  '''Directory of jax's persistent compilation cache: the one
  JAX_COMPILATION_CACHE_DIR names when it is set, else the fixed
  `.jax_cache` directory beside the package (inside the checkout; the
  path is part of the cache key, so it never moves).'''
  import os
  env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
  if env:
    return env
  return os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), '.jax_cache')


def _enableCompilationCache():
  '''Turn jax's persistent compilation cache on (reference analog: the
  workbench reuses one long-lived FreeCAD process so OCC state persists;
  here the expensive state is compiled XLA programs, which a cold process
  would otherwise rebuild in tens of seconds). When
  JAX_COMPILATION_CACHE_DIR is set jax reads it itself and nothing is
  configured here; otherwise the cache goes to compilationCacheDir().
  Opt out with ODW_NO_COMPILE_CACHE=1.'''
  import os
  if os.environ.get('ODW_NO_COMPILE_CACHE'):
    return
  if os.environ.get('JAX_COMPILATION_CACHE_DIR'):
    return
  import jax
  if jax.config.jax_compilation_cache_dir:
    return
  jax.config.update('jax_compilation_cache_dir', compilationCacheDir())
  jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)


_enableCompilationCache()


def versionInfo():
  '''Return a dict describing the framework version (reference:
  freecad/optics_design_workbench/__init__.py:58).'''
  import jax
  return dict(version=__version__,
              jax=jax.__version__,
              backend=jax.default_backend())
