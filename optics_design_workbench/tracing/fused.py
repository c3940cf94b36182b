'''
Fused Monte-Carlo fast path: sampling, the bounce loop and on-device hit
histogramming in ONE jitted step, carrying only histograms and counters
between steps — nothing ray-shaped ever reaches the host.

This is the throughput path behind the benchmark and every histogram-mode
simulation run. The reference's equivalent inner loop calls
OpenCASCADE per ray per face and pickles per-hit rows (ray.py:290-401,
results_store.py:641-648); here a bounce advances the whole batch and hits
are scatter-added into per-detector 2-D histograms in the recording
surface's local (x, y) frame.
'''

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .tracer import VACUUM_MEDIUM


def makeHistogramSpec(scene, info, recordElems=None, bounds=None,
                      bins=(128, 128)):
  '''Build the histogram config: which elements accumulate, one (H, W)
  histogram per recording element, binned over local-frame (x, y) `bounds`
  = (x0, x1, y0, y1) (shared, or dict label->bounds).'''
  elemLabels = info['elementLabels']
  recordFlags = np.asarray(scene['elements']['recordHits'])
  if recordElems is None:
    recordElems = [i for i in range(len(elemLabels)) if recordFlags[i]]
  elemToDet = np.full(len(elemLabels), -1, dtype=np.int32)
  allBounds = []
  for d, e in enumerate(recordElems):
    elemToDet[e] = d
    b = bounds
    if isinstance(bounds, dict):
      b = bounds.get(elemLabels[e])
    if b is None:
      b = (-50., 50., -50., 50.)
    allBounds.append(b)
  return dict(elemToDet=jnp.asarray(elemToDet),
              bounds=jnp.asarray(np.asarray(allBounds, dtype=np.float32)),
              bins=tuple(bins),
              detLabels=[elemLabels[e] for e in recordElems])


def initHistograms(histSpec, dtype=jnp.float32):
  D = histSpec['bounds'].shape[0]
  H, W = histSpec['bins']
  return dict(power=jnp.zeros((D, H, W), dtype),
              counts=jnp.zeros((D, H, W), dtype))


def binHits(hist, det, valid, x, y, power, bounds, bins):
  '''Scatter-add one bounce of hits into the (D, H, W) histograms: hit i
  lands on detector det[i] at local (x[i], y[i]) with weight power[i]
  (and count 1) when valid[i], det[i] >= 0 and it is inside that
  detector's bounds
  (x0, x1, y0, y1), half-open like np.histogram2d's inner bins. Returns
  (hist, number of hits binned).'''
  H, W = bins
  b = bounds[jnp.maximum(det, 0)]
  x0, x1, y0, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
  fx = (x - x0) / (x1 - x0)
  fy = (y - y0) / (y1 - y0)
  inside = (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1) & valid & (det >= 0)
  ix = jnp.clip((fx * W).astype(jnp.int32), 0, W - 1)
  iy = jnp.clip((fy * H).astype(jnp.int32), 0, H - 1)
  d0 = jnp.maximum(det, 0)
  w = jnp.where(inside, power, 0.)
  c = inside.astype(hist['counts'].dtype)

  def doScatter(hist):
    # one fused scatter-add for (power, counts); on a GPU it lowers to
    # atomic adds into the (D, H, W, 2) bins
    payload = jnp.stack([w, c], axis=-1)
    stacked = jnp.stack([hist['power'], hist['counts']], axis=-1)
    stacked = stacked.at[d0, iy, ix].add(payload)
    return dict(power=stacked[..., 0], counts=stacked[..., 1])

  # bounces without recordable hits skip the scatter entirely
  hist = lax.cond(jnp.any(inside), doScatter, lambda h: h, hist)
  return hist, jnp.sum(inside.astype(jnp.int32))


@partial(jax.jit, static_argnames=('maxIntersections', 'bins', 'flagsTuple',
                                   'earlyExit'))
def _traceHistogram(scene, elemToDet, bounds, bins, histograms, origins,
                    directions, powers, wavelengths, maxIntersections,
                    maxRayLength, distTol, flagsTuple=None, scatterKey=None,
                    earlyExit=True):
  from .batch_tracer import bounceBatch
  N = origins.shape[0]
  if scatterKey is None and 'scatter' in scene:
    scatterKey = jax.random.PRNGKey(0)
  flags = None if flagsTuple is None else dict(
      hasMirror=flagsTuple[0], hasLens=flagsTuple[1],
      hasGrating=flagsTuple[2],
      scatterConst=(flagsTuple[3] if len(flagsTuple) > 3 else None))
  state = (origins, directions, powers, wavelengths,
           jnp.full((N,), VACUUM_MEDIUM, dtype=jnp.int32),
           jnp.zeros((N,), dtype=jnp.int32),
           jnp.ones((N,), dtype=bool))

  def body(carry):
    i, state, hist, segments, hits = carry
    bounceKey = (jax.random.fold_in(scatterKey, i)
                 if scatterKey is not None else None)
    newState, rec = bounceBatch(scene, distTol, maxRayLength, *state,
                                staticFlags=flags, key=bounceKey)

    det = elemToDet[jnp.maximum(rec['hitElem'], 0)]
    valid = rec['recordHit'] & (rec['hitElem'] >= 0)
    # the batch tracer already provides the hit point in the recording
    # surface's local frame — no extra gathers needed
    hist, inside = binHits(hist, det, valid, rec['plx'], rec['ply'],
                           rec['power'], bounds, bins)
    segments = segments + jnp.sum(rec['segValid'].astype(jnp.int32))
    hits = hits + inside
    return (i + 1, newState, hist, segments, hits)

  def cond(carry):
    i, state, *_ = carry
    # early exit once every ray is dead (absorbed/escaped/below powerTol)
    return (i < maxIntersections) & jnp.any(state[6])

  init = (jnp.zeros((), jnp.int32), state, histograms,
          jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
  if earlyExit:
    i, state, histograms, segments, hits = lax.while_loop(cond, body, init)
  else:
    # fixed-trip-count scan variant, used by the batched scene sweep (its
    # lax.map over variants carries a fixed-length loop). A cond inside the
    # scan still skips the expensive sweep once every ray is dead.
    def scanBody(carry, _):
      return lax.cond(jnp.any(carry[1][6]), body,
                      lambda c: (c[0] + 1,) + c[1:], carry), None
    (i, state, histograms, segments, hits), _ = lax.scan(
        scanBody, init, None, length=maxIntersections)
  counters = dict(segments=segments, hits=hits,
                  escaped=jnp.sum(~state[6]))
  return histograms, counters


def traceHistogram(scene, histSpec, histograms, origins, directions, powers,
                   wavelengths, maxIntersections, maxRayLength, distTol,
                   scatterKey=None, earlyExit=True):
  '''Trace a batch and scatter-add recorded hits into the histograms.
  Returns (histograms, counters) with counters = dict(segments, hits,
  escaped). Non-array histSpec fields (bins, labels) are split off as
  static arguments so the call is jit/shard_map friendly. When the scene
  arrays are concrete (closure constants), interaction formulas for element
  types absent from the scene are compiled out.'''
  from .batch_tracer import sceneStaticFlags, scatterConstants
  flagsTuple = None
  if not isinstance(jnp.asarray(scene['elements']['optType']), jax.core.Tracer):
    try:
      f = sceneStaticFlags(scene)
      # scatterConstants is hashable (nested tuples) and rides the same
      # static slot: gather-free scatter draws when the tables allow
      flagsTuple = (f['hasMirror'], f['hasLens'], f['hasGrating'],
                    scatterConstants(scene))
    except Exception:
      flagsTuple = None
  return _traceHistogram(scene, histSpec['elemToDet'], histSpec['bounds'],
                         tuple(histSpec['bins']), histograms, origins,
                         directions, powers, wavelengths,
                         maxIntersections=maxIntersections,
                         maxRayLength=maxRayLength, distTol=distTol,
                         flagsTuple=flagsTuple, scatterKey=scatterKey,
                         earlyExit=earlyExit)


# Device bytes the fused step holds per (surface, ray) pair at its peak: the
# (S, N) distance matrices of batch_tracer.allDistancesBatch and their
# per-kind intermediates. Measured on an NVIDIA H100 (400 W limit) at the
# bench cell (5 surfaces x 4,194,304 rays: ~480 MB of temporaries, i.e.
# ~23 B per surface-ray including the per-ray state); rounded up for
# triangle-heavy scenes, whose Moeller-Trumbore sweep keeps more (S, N)
# temporaries live.
BYTES_PER_SURFACE_RAY = 32


def makeFusedStep(scene, generator, histSpec, raysPerStep, maxIntersections,
                  maxRayLength, distTol, stratified=False,
                  memoryBudgetBytes=4 << 30):
  '''Compose sampling + trace + histogram into one jitted step function
  `(key, histograms) -> (histograms, counters)`.

  Memory guard: the batch tracer materializes (S, N) distance matrices
  (batch_tracer.allDistancesBatch), so a many-surface scene at a large
  batch runs out of device memory. When S * raysPerStep *
  BYTES_PER_SURFACE_RAY exceeds `memoryBudgetBytes` the step folds the
  batch through a lax.scan over ray chunks instead — same results, bounded
  memory (chunking the RAY axis keeps every per-kind sweep and the
  tie-breaking semantics untouched).'''
  chunks = 1
  try:
    nSurf = int(np.asarray(scene['surfaces']['kind']).shape[0])
  except Exception:
    nSurf = 0                      # traced/abstract scene: no chunking
  while nSurf * (raysPerStep // chunks) * BYTES_PER_SURFACE_RAY \
      > memoryBudgetBytes and raysPerStep % (chunks * 2) == 0:
    chunks *= 2

  @jax.jit
  def fusedStep(key, histograms):
    batch = generator(key, raysPerStep, stratified=stratified)
    if chunks == 1:
      return traceHistogram(scene, histSpec, histograms,
                            batch['origins'], batch['directions'],
                            batch['powers'], batch['wavelengths'],
                            maxIntersections=maxIntersections,
                            maxRayLength=maxRayLength, distTol=distTol)
    Nc = raysPerStep // chunks
    xs = (batch['origins'].reshape(chunks, Nc, 3),
          batch['directions'].reshape(chunks, Nc, 3),
          batch['powers'].reshape(chunks, Nc),
          batch['wavelengths'].reshape(chunks, Nc),
          jnp.arange(chunks))

    def body(carry, x):
      hist, segs, hits, esc = carry
      o, d, p, w, i = x
      hist, c = traceHistogram(
          scene, histSpec, hist, o, d, p, w,
          maxIntersections=maxIntersections, maxRayLength=maxRayLength,
          distTol=distTol,
          scatterKey=jax.random.fold_in(key, 7700 + i))
      return (hist, segs + jnp.asarray(c['segments'], jnp.int32),
              hits + jnp.asarray(c['hits'], jnp.int32),
              esc + jnp.asarray(c['escaped'], jnp.int32)), None

    zero = jnp.int32(0)
    (hist, segs, hits, esc), _ = jax.lax.scan(
        body, (histograms, zero, zero, zero), xs)
    return hist, dict(segments=segs, hits=hits, escaped=esc)

  return fusedStep
