'''
Profiling and throughput observability.

The reference's observability is tracemalloc snapshots, ray-cache hit-rate
logs and rays/hour counters (SURVEY.md section 5; simulation_loop.py:43-60,
raytracing_cache.py:73-85, results_store.py:552-556). The device analog:
the JAX profiler for per-kernel timelines plus simple step-throughput
counters.
'''

import contextlib
import time

from . import io


@contextlib.contextmanager
def deviceTrace(logdir='/tmp/odw_profile'):
  '''Capture a JAX device profile (xplane) for everything inside the
  context; inspect with TensorBoard's profile plugin or the raw
  xplane.pb.'''
  import jax
  jax.profiler.start_trace(logdir)
  try:
    yield logdir
  finally:
    jax.profiler.stop_trace()
    io.info(f'device profile written to {logdir}')


class ThroughputMeter:
  '''Accumulates (rays, segments, hits) across steps and renders the
  reference-style performance description (results_store.py:552-556).'''

  def __init__(self):
    self.t0 = time.time()
    self.rays = 0
    self.segments = 0
    self.hits = 0

  def update(self, rays=0, segments=0, hits=0):
    self.rays += int(rays)
    self.segments += int(segments)
    self.hits += int(hits)

  def description(self):
    dt = max(time.time() - self.t0, 1e-9)
    return (f'{self.rays/dt*3600:.3g} rays/hour '
            f'({self.rays/dt/1e6:.2f} M rays/s), '
            f'{self.segments/dt/1e6:.2f} M segments/s, '
            f'{self.hits/dt*3600:.3g} recorded hits/hour')


class TracemallocReporter:
  '''Periodic host-allocation report — the analog of the reference's
  optional tracemalloc top-20 dump every _TRACEMALLOC_INTERVAL seconds
  (simulation_loop.py:43, 58-60, 548-551; disabled by an `inf` interval in
  release builds). Enable by passing a finite interval or setting
  ODW_TRACEMALLOC=<seconds> in the environment; the runner calls
  maybeReport() once per iteration.'''

  def __init__(self, intervalSeconds=None, top=20):
    import os
    if intervalSeconds is None:
      raw = os.environ.get('ODW_TRACEMALLOC', 'inf')
      try:
        intervalSeconds = float(raw)
      except ValueError:
        io.warn(f'ODW_TRACEMALLOC={raw!r} is not a number; '
                f'tracemalloc reporting disabled')
        intervalSeconds = float('inf')
    self.interval = float(intervalSeconds)
    self.top = int(top)
    self._next = None
    if self.enabled:
      import tracemalloc
      if not tracemalloc.is_tracing():
        tracemalloc.start()
      self._next = time.time() + self.interval

  @property
  def enabled(self):
    return self.interval not in (float('inf'),) and self.interval > 0

  def maybeReport(self):
    if not self.enabled or time.time() < self._next:
      return False
    self._next = time.time() + self.interval
    import tracemalloc
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics('lineno')[:self.top]
    total = sum(s.size for s in snap.statistics('filename')) / 1e6
    lines = [f'tracemalloc: {total:.1f} MB traced, top {len(stats)}:']
    for s in stats:
      frame = s.traceback[0]
      lines.append(f'  {s.size/1e6:7.2f} MB  {frame.filename}:{frame.lineno}'
                   f' (x{s.count})')
    io.info('\n'.join(lines))
    return True
