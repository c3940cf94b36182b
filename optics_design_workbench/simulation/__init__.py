from .runner import runSimulation, runAction, setupRandomSeed
from .lifecycle import Lifecycle, SimulationEnded
from .results_store import (SimulationResults, getResultsFolderPath,
                            generateSimulationFolderName, getLatestRunIndex,
                            chunkFiles)


def cpuCount():
  '''Shard-count analog of the reference's physical-core detection
  (reference: simulation_loop.py:778-810): the natural shard count
  is the local device count.'''
  import jax
  return jax.local_device_count()
