from .mesh import makeMesh, raysSharding
from .sharded import makeShardedFusedStep
from .multiprocess import runMultiprocess
