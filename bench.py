#!/usr/bin/env python
'''
Headline benchmark: Monte-Carlo ray-segments per second of the fused
sample+trace+histogram step on the examples/2-style lens+mirror+detector
scene (4,194,304 rays per step, 6 bounces, 128x128 detector bins). Prints
ONE JSON line on stdout:
{"metric": ..., "value": N, "unit": ..., "device": {...}}.
A failing step raises and the process exits non-zero; nothing is printed
on stdout then.
'''

import json
import sys
import time

import jax


def main():
  from optics_design_workbench import benchmarks

  raysPerStep = 1 << 22
  step, hist, meta = benchmarks.makeBenchStep(raysPerStep=raysPerStep,
                                              maxIntersections=6,
                                              bins=(128, 128))
  key = jax.random.PRNGKey(0)

  # warmup / compile
  t0 = time.perf_counter()
  hist, counters = step(jax.random.fold_in(key, 0), hist)
  jax.block_until_ready((hist, counters))
  compileTime = time.perf_counter() - t0
  print(f'compile+first step: {compileTime:.1f}s, '
        f'{int(counters["segments"])} segments/step, '
        f'{int(counters["hits"])} hits/step, device={jax.devices()[0]}',
        file=sys.stderr)

  # timed steps, best of 3 windows; each window ends in block_until_ready
  best = 0.
  for window in range(3):
    segCounts = []
    t0 = time.perf_counter()
    for i in range(16):
      hist, counters = step(jax.random.fold_in(key, 100 * window + i + 1),
                            hist)
      segCounts.append(counters['segments'])
    jax.block_until_ready((hist, segCounts))
    dt = time.perf_counter() - t0
    segPerSec = sum(int(c) for c in segCounts) / dt
    print(f'window {window}: {len(segCounts)} steps x {raysPerStep} rays in '
          f'{dt:.3f}s -> {segPerSec/1e6:.1f} M segments/s, '
          f'{len(segCounts)*raysPerStep/dt/1e6:.1f} M rays/s',
          file=sys.stderr)
    best = max(best, segPerSec)

  dev = jax.devices()[0]
  print(json.dumps(dict(metric='mc_ray_segments_per_sec', value=best,
                        unit='segments/s',
                        device=dict(platform=dev.platform,
                                    kind=dev.device_kind,
                                    count=len(jax.devices())))))


if __name__ == '__main__':
  main()
