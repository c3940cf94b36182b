'''
OS-process worker pool — the host-level analog of the reference's
master/worker architecture (reference: simulation/processes/
simulation_loop.py:449-632, worker_process.py). Where the reference spawns
`FreeCAD -c` children driven over stdin, here each worker is a plain python
subprocess that unpickles the scene and re-enters
`simulation.runSimulation(action, slaveInfo=...)` in worker role:

  * the master creates the run folder + lifecycle flags and aggregates the
    workers' atomic progress dumps (`SimulationResults.getProgress`,
    reference: results_store.py:462-550);
  * workers flush their own result files into the shared run folder (the
    folder contract keys files by pid so writers never collide) and dump
    cumulative progress (`dumpProgress(workerId=...)`);
  * end criteria are evaluated by the master over the SUMMED counters; the
    `simulation-is-done` flag stops every worker; a dead master (parent
    pid probe) stops them too.

One process per card: a JAX process reserves most of a GPU's memory when it
first uses it, so a second process on the same card fails for want of
memory. Workers on a GPU host therefore get one card each
(CUDA_VISIBLE_DEVICES), and the master never touches a device. Single-host
device parallelism inside one process goes through jax.sharding instead
(parallel/sharded.py).
'''

import os
import pickle
import subprocess
import sys
import tempfile
import time

from ..utils import io


def visibleGpuIds():
  '''Ids of the NVIDIA GPUs a worker process could open, found without
  initializing any jax backend in this process: the entries of
  CUDA_VISIBLE_DEVICES when it is set, else the GPUs `nvidia-smi -L`
  lists. Empty when jax is held off the GPU (JAX_PLATFORMS or the
  jax_platforms config without cuda/gpu) or no GPU is present.'''
  import jax
  plats = os.environ.get('JAX_PLATFORMS') or jax.config.jax_platforms or ''
  if plats and not ({'cuda', 'gpu'} & set(plats.replace(' ', '').split(','))):
    return []
  vis = os.environ.get('CUDA_VISIBLE_DEVICES')
  if vis is not None:
    return [v.strip() for v in vis.split(',')
            if v.strip() and v.strip() != '-1']
  try:
    out = subprocess.run(['nvidia-smi', '-L'], capture_output=True,
                         text=True, timeout=30).stdout
  except (OSError, subprocess.SubprocessError):
    return []
  return [str(i) for i, line in enumerate(
      l for l in out.splitlines() if l.startswith('GPU '))]


def workerEnvironments(workerCount, forceCpu, baseEnv, gpuIds=None):
  '''One environment per worker: with forceCpu every worker runs on the
  CPU; otherwise, when GPUs are visible, worker i gets card i alone
  (CUDA_VISIBLE_DEVICES) and more workers than cards are refused.'''
  if gpuIds is None:
    gpuIds = [] if forceCpu else visibleGpuIds()
  envs = []
  for w in range(int(workerCount)):
    env = dict(baseEnv)
    if forceCpu:
      env['JAX_PLATFORMS'] = 'cpu'
    elif gpuIds:
      if int(workerCount) > len(gpuIds):
        raise ValueError(
            f'{workerCount} workers but {len(gpuIds)} GPU(s): each worker '
            f'is a JAX process that reserves most of its card\'s memory, so '
            f'two workers cannot share a card. Use at most {len(gpuIds)} '
            f'workers, or forceCpu=True to run them on the CPU.')
      env['CUDA_VISIBLE_DEVICES'] = gpuIds[w]
    envs.append(env)
  return envs


_WORKER_SNIPPET = '''
import pickle, sys
import jax
if {forceCpu!r}:
  jax.config.update('jax_platforms', 'cpu')
with open({scenePath!r}, 'rb') as f:
  scene = pickle.load(f)
from optics_design_workbench import simulation
simulation.runSimulation(
    scene, {action!r},
    slaveInfo=dict(simulationRunFolder={runFolder!r},
                   workerId={workerId!r}, parentPid={parentPid!r},
                   workerIndex={workerIndex!r}, workerCount={workerCount!r}),
    store=True, recording={recording!r})
'''


def runMultiprocess(scene, action, workerCount=2, pollSeconds=.5,
                    timeoutSeconds=3600, forceCpu=False, recording='raw',
                    maxWorkerReviveCount=3, env=None,
                    workerMaxLifetimeSeconds=None):
  '''Run `action` on `scene` with `workerCount` OS worker processes writing
  into one shared run folder; returns the run folder path. The master
  process does no tracing itself (the reference's lazy-master mainloop B,
  simulation_loop.py:634-707). A worker that DIES (nonzero exit) while a
  continuous run is still going is revived up to `maxWorkerReviveCount`
  times (the reference's worker babysitting, simulation_loop.py:688-698).
  workerMaxLifetimeSeconds gives workers a scheduled end-of-life (+ up to
  20% random jitter so they never all respawn together) after which they
  are cleanly respawned — the reference does this (10 h + 2 h jitter,
  worker_process.py:44-45, simulation_loop.py:483-494) to outrun FreeCAD
  memory leaks; here it bounds any slow host-side growth on week-long
  runs. Scheduled respawns do not count against maxWorkerReviveCount.
  Workers run on the CPU with forceCpu=True; otherwise each gets one GPU
  of its own when GPUs are visible (workerEnvironments), and more
  workers than GPUs are refused.'''
  from ..simulation import results_store
  from ..simulation.lifecycle import Lifecycle

  baseEnv = dict(os.environ)
  baseEnv['PYTHONPATH'] = os.pathsep.join(
      p for p in [os.path.dirname(os.path.dirname(os.path.dirname(
          os.path.abspath(__file__)))), baseEnv.get('PYTHONPATH', '')] if p)
  if env:
    baseEnv.update(env)
  workerEnvs = workerEnvironments(workerCount, forceCpu, baseEnv)

  resultsFolder = results_store.getResultsFolderPath(
      scene.path or scene.label)
  lifecycle = Lifecycle(resultsFolder)
  if lifecycle.isRunning():
    raise RuntimeError('a simulation is already running for this document')
  settings = scene.activeSimulationSettings()

  runFolder = results_store.generateSimulationFolderName(resultsFolder)
  results = results_store.SimulationResults(
      simulationType=action, basePath=resultsFolder,
      simulationRunFolder=runFolder,
      endAfterIterations=settings.endAfterIterations(),
      endAfterRays=settings.endAfterRays(),
      endAfterHits=settings.endAfterHits())
  results.dumpGlobalInfo(scene.collectGlobalInfo())
  lifecycle.clearAll()
  lifecycle.setIsRunning(True)

  sceneFile = tempfile.NamedTemporaryFile(
      suffix='.scene.pkl', delete=False)
  with sceneFile as f:
    pickle.dump(scene, f)

  procs = []
  try:
    def launch(w, restart=0):
      code = _WORKER_SNIPPET.format(
          forceCpu=bool(forceCpu), scenePath=sceneFile.name,
          action=action, runFolder=runFolder, workerId=f'w{w}r{restart}',
          parentPid=os.getpid(), recording=recording,
          workerIndex=w, workerCount=int(workerCount))
      return subprocess.Popen([sys.executable, '-c', code],
                              env=workerEnvs[w])

    restarts = [0] * int(workerCount)      # unique-workerId incarnations
    crashRevives = [0] * int(workerCount)  # counted against the revive cap
    # end-of-life clocks start at the incarnation's FIRST progress dump,
    # not at launch: interpreter/jit startup must not eat into the
    # lifetime (a short lifetime would otherwise starve slow-importing
    # workers into a kill-before-work loop)
    firstProgress = [None] * int(workerCount)
    eolAt = [None] * int(workerCount)
    if workerMaxLifetimeSeconds:
      import random as _random
      eolAt = [workerMaxLifetimeSeconds * (1. + .2 * _random.random())
               for _ in range(int(workerCount))]
    for w in range(int(workerCount)):
      procs.append(launch(w))

    continuous = action in ('true', 'pseudo')
    t0 = time.time()
    while True:
      progress = results.getProgress()
      lifecycle.touchRunning()
      if progress['reachedEnd']:
        lifecycle.setIsFinished(True)
        break
      if lifecycle.isCanceled():
        break
      # babysit: revive a crashed worker (nonzero exit) of a continuous run
      # (reference: simulation_loop.py:688-698); a clean exit means it saw
      # an end condition and is not revived
      if continuous:
        for w, p in enumerate(procs):
          rc = p.poll()
          if rc is not None and rc != 0 \
              and crashRevives[w] < int(maxWorkerReviveCount):
            crashRevives[w] += 1
            restarts[w] += 1
            io.warn(f'worker {w} died (rc={rc}); reviving '
                    f'(#{crashRevives[w]}/{maxWorkerReviveCount})')
            firstProgress[w] = None
            procs[w] = launch(w, restarts[w])
          elif rc is None and eolAt[w] is not None:
            key = f'w{w}r{restarts[w]}'
            if firstProgress[w] is None \
                and key in results.progressByWorker:
              firstProgress[w] = time.time()
            if firstProgress[w] is not None \
                and time.time() - firstProgress[w] > eolAt[w]:
              # scheduled end-of-life: clean respawn, not a crash revival
              io.info(f'worker {w} reached its scheduled end-of-life '
                      f'({eolAt[w]:.0f}s of work); respawning')
              p.terminate()
              try:
                p.wait(timeout=10)
              except subprocess.TimeoutExpired:
                p.kill()
              restarts[w] += 1
              firstProgress[w] = None
              procs[w] = launch(w, restarts[w])
      if all(p.poll() is not None for p in procs):
        # every worker exited on its own (single-shot actions / all dead)
        break
      if time.time() - t0 > timeoutSeconds:
        io.warn('multiprocess run timed out; stopping workers')
        lifecycle.setIsCanceled(True)
        break
      time.sleep(pollSeconds)

    # drain: workers see the done flag and exit; escalate after a grace
    # period (reference: worker_process.py:200-221 quit->terminate->kill)
    deadline = time.time() + 30
    for p in procs:
      try:
        p.wait(timeout=max(.1, deadline - time.time()))
      except subprocess.TimeoutExpired:
        p.terminate()
        try:
          p.wait(timeout=5)
        except subprocess.TimeoutExpired:
          p.kill()
    # final aggregation over the workers' last cumulative dumps
    results.getProgress()
  finally:
    lifecycle.setIsFinished(True)
    lifecycle.setIsRunning(False)
    lifecycle.setIsCanceled(False)
    try:
      os.unlink(sceneFile.name)
    except OSError:
      pass
    io.gatherWorkerLogs()
  return results.runPath()
