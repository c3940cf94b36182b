'''
Multi-device fused Monte-Carlo step via `shard_map`: each device samples its
own keyed stream, traces its shard of the ray batch against the replicated
scene and scatter-adds into a local histogram; histograms and counters ride
a single `psum` (an NCCL all-reduce over NVLink on a GPU host). This
replaces the reference's N worker processes + filesystem progress protocol
(simulation_loop.py:449-632; results_store.py:462-539).
'''

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..tracing.fused import traceHistogram


def makeShardedFusedStep(mesh, scene, generator, histSpec, raysPerStep,
                         maxIntersections, maxRayLength, distTol,
                         stratified=False, axisName='rays'):
  '''Build `(key, histograms) -> (histograms, counters)` where the ray axis
  is sharded over `mesh` and outputs are replicated (psum).
  `raysPerStep` is the GLOBAL batch size (must divide by mesh size).'''
  nShards = mesh.shape[axisName]
  if raysPerStep % nShards:
    raise ValueError(f'raysPerStep={raysPerStep} must be divisible by the '
                     f'mesh size {nShards}')
  perShard = raysPerStep // nShards

  def shardStep(key, histograms):
    # per-shard keyed stream (reference analog: per-worker random seeds,
    # simulation_loop.py:813-820)
    shardIdx = jax.lax.axis_index(axisName)
    key = jax.random.fold_in(key[0], shardIdx)
    batch = generator(key, perShard, stratified=stratified)
    # accumulate into a zero local histogram, psum the delta, then add to
    # the (replicated) running histograms — adding into the running copy on
    # every shard would multiply it by the shard count under psum
    local = jax.tree.map(jnp.zeros_like, histograms)
    delta, counters = traceHistogram(
        scene, histSpec, local,
        batch['origins'], batch['directions'], batch['powers'],
        batch['wavelengths'], maxIntersections=maxIntersections,
        maxRayLength=maxRayLength, distTol=distTol)
    delta = jax.tree.map(lambda h: jax.lax.psum(h, axisName), delta)
    counters = jax.tree.map(lambda c: jax.lax.psum(c, axisName), counters)
    hist = jax.tree.map(jnp.add, histograms, delta)
    return hist, counters

  sharded = shard_map(
      shardStep, mesh=mesh,
      in_specs=(P(axisName), P()),
      out_specs=(P(), P()),
      check_vma=False)

  @jax.jit
  def step(key, histograms):
    # distribute one key per shard
    keys = jax.random.split(key, nShards)
    return sharded(keys, histograms)

  return step
