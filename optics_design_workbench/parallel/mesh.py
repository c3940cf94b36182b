'''
Device-mesh helpers. The reference's parallelism is N independent OS worker
processes communicating via the filesystem (SURVEY.md section 2.2); here it
is a flat 1-D `rays` mesh over the local devices: the ray batch axis is
sharded, hit histograms are psum-reduced, and the host only ever sees
aggregate results. The mesh stays flat because the GPUs of one host are
joined all to all by NVLink, so no device pair is closer than another and
the algorithm (independent ray shards + one all-reduce) needs no topology.
Multi-host scale-out uses `jax.distributed` with the same mesh spanning all
processes.
'''

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def makeMesh(nDevices=None, axisName='rays', devices=None):
  '''1-D mesh over the local (or given) devices.'''
  if devices is None:
    devices = jax.devices()
  if nDevices is not None:
    devices = devices[:nDevices]
  return Mesh(np.array(devices), (axisName,))


def raysSharding(mesh, axisName='rays'):
  return NamedSharding(mesh, P(axisName))


def replicatedSharding(mesh):
  return NamedSharding(mesh, P())


def initDistributed(coordinatorAddress=None, numProcesses=None,
                    processId=None):
  '''Multi-host initialization; no-op when single process. The
  coordinator address, process count and process id must be given: nothing
  on a plain GPU host tells jax of a cluster.'''
  if numProcesses is None or numProcesses <= 1:
    return
  jax.distributed.initialize(coordinator_address=coordinatorAddress,
                             num_processes=numProcesses,
                             process_id=processId)
