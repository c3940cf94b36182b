'''
Simulation runtime — the single-controller analog of the reference's
master/worker mainloop (reference: simulation/processes/simulation_loop.py:
291-775). Where the reference spawns N FreeCAD worker processes that each
trace rays one by one, this runner jits one sample+trace step over the whole
ray batch and (optionally) shards the batch axis across all local devices;
"worker count" becomes the shard count. Lifecycle flag files, the results
folder layout, progress dumps, end criteria and the per-source iteration
structure are preserved so external tooling behaves identically.

Actions (reference: simulation_actions.py:22-37, simulation_loop.py:341-348):
  'fans'         one deterministic ray-fan iteration
  'singletrue'   one Monte-Carlo iteration (true random)
  'singlepseudo' one Monte-Carlo iteration (low-discrepancy)
  'true'         continuous Monte-Carlo until end criteria / cancel
  'pseudo'       continuous low-discrepancy Monte-Carlo
  'stop'         cancel a running simulation
  'clear'        stop + clear drawn rays (GUI no-op here)
'''

import os
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .. import distributions
from ..models.point_source import PointSource
from ..tracing import trace
from ..utils import io, timing
from . import results_store
from .lifecycle import Lifecycle, SimulationEnded

SINGLE_SHOT_ACTIONS = ('fans', 'singletrue', 'singlepseudo')
CONTINUOUS_ACTIONS = ('true', 'pseudo')


def setupRandomSeed(seed=None):
  '''Per-process random seeding (reference: simulation_loop.py:813-820).'''
  if seed is None:
    seed = int(time.time() * 1e3) % (2 ** 31)
  distributions.setGlobalSeed(seed)
  np.random.seed(seed % (2 ** 31))
  return jax.random.PRNGKey(seed)


def _actionMode(action):
  if action in ('singletrue', 'true'):
    return 'true'
  if action in ('singlepseudo', 'pseudo'):
    return 'pseudo'
  if action == 'fans':
    return 'fans'
  raise ValueError(f'unexpected action {action!r}')


@partial(jax.jit, static_argnames=('padTo',))
def _compactHitRecords(recordHit, hitElem, point, direction, power,
                       isEntering, padTo):
  '''Device-side hit compaction: bring the recording rows of the (B, N)
  bounce-major records to the front so the host fetches `padTo` rows
  instead of all B*N (full records are ~120 MB per iteration at 2^18
  rays and 6 bounces, most of them rows that recorded nothing).'''
  B, N = recordHit.shape
  flat = recordHit.reshape(-1)
  order = jnp.argsort(~flat)[:padTo]        # stable: valid rows first

  def take(x):
    return x.reshape((B * N,) + x.shape[2:])[order]

  return dict(count=jnp.sum(flat.astype(jnp.int32)),
              hitElem=take(hitElem), point=take(point),
              direction=take(direction), power=take(power),
              isEntering=take(isEntering),
              rayIdx=(order % N).astype(jnp.int32))


def compactRecordsToHits(records, metadata, elementLabels,
                         enabledKeys=None, padTo=None):
  '''recordsToHits via device-side compaction: fetches only the recording
  rows (padded to the next power of two) instead of the full (B, N)
  records. Falls back to the full fetch when more than `padTo` hits were
  recorded (a ray can hit several recording elements across bounces).'''
  B, N = records['recordHit'].shape
  if padTo is None:
    padTo = min(B * N, max(1024, N))
  comp = _compactHitRecords(records['recordHit'], records['hitElem'],
                            records['point'], records['direction'],
                            records['power'], records['isEntering'],
                            padTo=padTo)
  count = int(comp['count'])
  if count == 0:
    return {}
  if count > padTo:
    io.verb(f'{count} recorded hits exceed the {padTo}-row compaction '
            f'buffer; falling back to the full record fetch')
    return recordsToHits(records, metadata, elementLabels, enabledKeys)
  bucket = 1 << max(0, (count - 1).bit_length())   # pow2 >= count
  bucket = min(bucket, padTo)
  hitElem = np.asarray(comp['hitElem'][:bucket])[:count]
  points = np.asarray(comp['point'][:bucket])[:count]
  directions = np.asarray(comp['direction'][:bucket])[:count]
  powers = np.asarray(comp['power'][:bucket])[:count]
  isEntering = np.asarray(comp['isEntering'][:bucket])[:count]
  rayIdx = np.asarray(comp['rayIdx'][:bucket])[:count]
  out = {}
  for e, label in enumerate(elementLabels):
    m = hitElem == e
    if not m.any():
      continue
    cols = dict(points=points[m], directions=directions[m],
                powers=powers[m], isEntering=isEntering[m])
    nIdx = rayIdx[m]
    for k, v in (metadata or {}).items():
      if enabledKeys is not None and k.lower() not in enabledKeys:
        continue
      cols[k] = np.asarray(v)[nIdx]
    out[label] = cols
  return out


def recordsToHits(records, metadata, elementLabels, enabledKeys=None):
  '''Convert bounce-major device records into per-element columnar hit
  batches: {elementLabel: dict(points, directions, powers, isEntering,
  metadata columns)} (host side).'''
  recordHit = np.asarray(records['recordHit'])          # (B, N)
  hitElem = np.asarray(records['hitElem'])
  out = {}
  if not recordHit.any():
    return out
  points = np.asarray(records['point'])
  directions = np.asarray(records['direction'])
  powers = np.asarray(records['power'])
  isEntering = np.asarray(records['isEntering'])
  rayIdx = np.broadcast_to(np.arange(hitElem.shape[1]), hitElem.shape)
  for e, label in enumerate(elementLabels):
    mask = recordHit & (hitElem == e)
    if not mask.any():
      continue
    sel = np.nonzero(mask)
    nIdx = rayIdx[sel]
    cols = dict(points=points[sel], directions=directions[sel],
                powers=powers[sel], isEntering=isEntering[sel])
    for k, v in (metadata or {}).items():
      if enabledKeys is not None and k.lower() not in enabledKeys:
        continue
      cols[k] = np.asarray(v)[nIdx]
    out[label] = cols
  return out


def recordsToRays(records, elementLabels):
  '''Convert segment records into the ragged polyline encoding consumed by
  SimulationResults.addRayBatch.'''
  segValid = np.asarray(records['segValid'])            # (B, N)
  if not segValid.any():
    return None
  p1 = np.asarray(records['segP1'])                     # (B, N, 3)
  p2 = np.asarray(records['segP2'])
  power = np.asarray(records['segPower'])
  medium = np.asarray(records['segMedium'])
  B, N = segValid.shape
  counts = segValid.sum(axis=0)                          # (N,)
  keep = counts > 0
  pointsList, powersList, mediaList = [], [], []
  offsets = [0]
  labelArr = np.array([str(l) for l in elementLabels] + ['None'])
  for n in np.nonzero(keep)[0]:
    k = counts[n]
    pts = np.concatenate([p1[:k, n], p2[k - 1:k, n]])    # (k+1, 3)
    pointsList.append(pts)
    powersList.append(power[:k, n])
    med = medium[:k, n]
    mediaList.append(labelArr[np.where(med < 0, len(elementLabels), med)])
    offsets.append(offsets[-1] + k + 1)
  return dict(points=np.concatenate(pointsList),
              powers=np.concatenate(powersList),
              media=np.concatenate(mediaList),
              offsets=np.array(offsets))


class SimulationRun:
  '''One compiled simulation: scene on device + per-source generators.'''

  def __init__(self, scene, settings, mesh=None):
    self.scene = scene
    self.settings = settings
    self.device, self.info = scene.compile()
    self.device['powerTol'] = 1e-6
    self.mesh = mesh
    self.sharding = None
    if mesh is not None:
      from jax.sharding import NamedSharding, PartitionSpec as P
      self.sharding = NamedSharding(mesh, P('rays'))

  def sceneFor(self, source):
    mask = self.info['surfaceMasks'].get(source.Label)
    if mask is None:
      return self.device
    sc = dict(self.device)
    sc['surfMask'] = mask
    return sc

  def _shard(self, batch):
    '''Shard the rays axis over the mesh. Batches whose size does not
    divide the mesh (deterministic fans with arbitrary ray counts) are
    padded with throwaway rays aimed at infinity (they escape on bounce 1
    and record nothing) so fan work splits statically across every device
    — the analog of the reference's initial-conditions file queue
    (results_store.py:679-738).'''
    if self.sharding is None:
      return batch
    n = len(batch['origins'])
    m = self.mesh.size
    pad = (-n) % m
    if pad:
      batch = dict(batch)
      far = np.broadcast_to(np.array([1e7, 1e7, 1e7]), (pad, 3))
      up = np.broadcast_to(np.array([0., 0., 1.]), (pad, 3))
      batch['origins'] = np.concatenate(
          [np.asarray(batch['origins']), far])
      batch['directions'] = np.concatenate(
          [np.asarray(batch['directions']), up])
      batch['powers'] = np.concatenate(
          [np.asarray(batch['powers']), np.zeros(pad)])
      batch['wavelengths'] = np.concatenate(
          [np.asarray(batch['wavelengths']),
           np.full(pad, np.asarray(batch['wavelengths']).flat[0]
                   if n else 550.)])

    def put(x):
      if hasattr(x, 'shape') and getattr(x, 'ndim', 0) >= 1 \
          and x.shape[0] % m == 0:
        return jax.device_put(jnp.asarray(x), self.sharding)
      return x
    return {k: (put(v) if k != 'metadata' else v) for k, v in batch.items()}

  def traceBatch(self, source, batch, recordSegments, key=None):
    sc = self.sceneFor(source)
    batch = self._shard(batch)
    maxI = max(1, int(round(self.settings.maxIntersections()
                            * float(source.MaxIntersectionsScale))))
    maxL = self.settings.maxRayLength() * float(source.MaxRayLengthScale)
    state, records = trace(
        sc, jnp.asarray(batch['origins'], jnp.float32),
        jnp.asarray(batch['directions'], jnp.float32),
        jnp.asarray(batch['powers'], jnp.float32),
        jnp.asarray(batch['wavelengths'], jnp.float32),
        maxIntersections=maxI, maxRayLength=maxL,
        distTol=self.settings.deviceDistanceTolerance(),
        recordSegments=recordSegments, key=key)
    return state, records


def _sliceBatch(batch, index, count):
  '''Strided slice [index::count] of every per-ray column in a generated
  ray batch (origins/directions/powers/wavelengths + metadata arrays).'''
  n = len(batch['origins'])
  out = {}
  for k, v in batch.items():
    if k == 'metadata':
      out[k] = {mk: (np.asarray(mv)[index::count]
                     if hasattr(mv, '__len__') and len(mv) == n else mv)
                for mk, mv in v.items()}
    elif hasattr(v, '__len__') and len(v) == n:
      out[k] = np.asarray(v)[index::count]
    else:
      out[k] = v
  return out


def runSimulation(scene, action, endIf=None, seed=None, store=None,
                  draw=False, mesh=None, progressCallback=None,
                  flushEverySeconds=5, recording='raw',
                  histBounds=None, histBins=(256, 256),
                  rawSampleRays=1 << 13, rawSampleEvery=8,
                  slaveInfo=None):
  '''
  Run a simulation on `scene` (a models.Scene). Returns the run folder path
  (or None for 'stop'/'clear'). See module docstring for actions.

  recording='histogram' switches continuous Monte-Carlo runs to
  histogram-first storage: detector histograms accumulate ON DEVICE every
  iteration through the fused sample+trace+bin step
  (tracing/fused.makeFusedStep) and are flushed as cumulative snapshots
  (source-<label>/<ts>-histograms.npz, loader:
  results_store.loadHistogramSnapshots); only a capped raw-hit sample
  (`rawSampleRays` rays every `rawSampleEvery` iterations) goes through the
  record-producing path for metadata-rich rows, so a storing run keeps the
  fused step's throughput instead of fetching every hit to the host.
  histBounds: detector-local (x0, x1, y0, y1) or dict label->bounds.

  draw=True collects the traced polylines of a SINGLE-SHOT action into a
  simulation.draw.DrawnRays (written to the run folder as drawn-rays.ply /
  .npz — the headless analog of the reference GUI's drawn ray objects,
  generic_source.py:86-140). Pass an existing DrawnRays instance as `draw`
  to collect into it; continuous actions ignore draw with a warning (the
  reference GUI likewise only draws single-shot actions).
  '''
  resultsFolder = results_store.getResultsFolderPath(
      scene.path or scene.label)
  lifecycle = Lifecycle(resultsFolder)

  if action in ('stop', 'clear'):
    lifecycle.setIsCanceled(True)
    for src in scene.lightSources():
      src.clear()
    return None

  if action not in SINGLE_SHOT_ACTIONS + CONTINUOUS_ACTIONS:
    raise ValueError(f'unknown action {action!r}')

  if slaveInfo is None and lifecycle.isRunning():
    raise RuntimeError('a simulation is already running for this document')

  settings = scene.activeSimulationSettings()
  mode = _actionMode(action)
  continuous = action in CONTINUOUS_ACTIONS

  # headless ray drawing (single-shot only — matches the GUI)
  drawn, drawParams = None, {}
  if draw:
    if continuous:
      io.warn('draw=True is ignored for continuous actions '
              '(the reference GUI only draws single-shot runs)')
    else:
      from . import draw as drawMod
      drawn = (draw if isinstance(draw, drawMod.DrawnRays)
               else drawMod.DrawnRays())
      drawParams = drawMod.sceneDrawParams(scene)

  # WorkerProcessCount -> shard count: an explicit integer > 1 requests the
  # batch be sharded over that many local devices (the analog of the
  # reference's N worker processes, simulation_loop.py:387-396). The
  # 'num_cpus' default keeps single-device execution to avoid surprising
  # sharding of tiny batches.
  if mesh is None:
    raw = getattr(settings, 'WorkerProcessCount', 'num_cpus')
    try:
      requested = int(float(raw))
    except (TypeError, ValueError):
      requested = 1
    nDev = jax.local_device_count()
    if requested > 1 and nDev > 1:
      from ..parallel import makeMesh
      mesh = makeMesh(nDevices=min(requested, nDev))
      io.verb(f'sharding ray batches over {mesh.size} devices '
              f'(WorkerProcessCount={raw})')
  # store decisions (reference: simulation_loop.py:350-378): continuous runs
  # always store; single-shot only with EnableStoreSingleShotData (or when
  # explicitly requested)
  if store is None:
    store = continuous or bool(settings.EnableStoreSingleShotData)

  # worker role (reference: simulation_loop.py slaveInfo, :291, :555-632):
  # a worker joins an EXISTING run folder, reports progress via atomic
  # per-worker dumps instead of aggregating, never touches lifecycle
  # flags, and exits when the master sets done/canceled or its parent dies
  isWorker = slaveInfo is not None
  _inCleanup = [False]
  _prevSigterm = None
  if isWorker:
    # graceful shutdown on SIGTERM (the master's scheduled end-of-life and
    # drain escalation send it): raise SimulationEnded so the finally block
    # flushes buffered results, drains the native spool and dumps the final
    # cumulative progress — otherwise up to flushEverySeconds of traced
    # hits silently vanish while the master's summed counters keep them.
    # Once cleanup starts the handler goes quiet (a second SIGTERM must
    # not abort the flush it exists to guarantee); the previous handler is
    # restored on exit so embedding processes keep their own semantics
    import signal as _signal

    def _onSigterm(*_args):
      if not _inCleanup[0]:
        raise SimulationEnded()
    try:
      _prevSigterm = _signal.getsignal(_signal.SIGTERM)
      _signal.signal(_signal.SIGTERM, _onSigterm)
    except ValueError:
      _prevSigterm = None   # not the main thread (in-process worker); skip
  workerId = (slaveInfo or {}).get('workerId')
  parentPid = (slaveInfo or {}).get('parentPid')
  workerIndex = int((slaveInfo or {}).get('workerIndex', 0))
  workerCount = int((slaveInfo or {}).get('workerCount', 1))
  if isWorker and seed is None:
    # workers need decorrelated streams even when spawned in the same ms
    seed = (int(time.time() * 1e3) + os.getpid() * 7919) % (2 ** 31)

  key = setupRandomSeed(seed)
  if not isWorker:
    lifecycle.clearAll()
    lifecycle.setIsRunning(True)

  deviceGens = {}
  results = None
  hists = {}         # referenced in `finally` — must exist even when the
                     # run fails before the histogram-mode setup below
  try:
    endIter = settings.endAfterIterations() if continuous else 1
    results = results_store.SimulationResults(
        simulationType=action,
        basePath=resultsFolder,
        simulationRunFolder=(slaveInfo['simulationRunFolder'] if isWorker
                             else results_store.generateSimulationFolderName(
                                 resultsFolder)),
        flushEverySeconds=flushEverySeconds,
        endAfterIterations=endIter,
        endAfterRays=settings.endAfterRays() if continuous else np.inf,
        endAfterHits=settings.endAfterHits() if continuous else np.inf)
    if not isWorker:
      results.dumpGlobalInfo(scene.collectGlobalInfo())

    run = SimulationRun(scene, settings, mesh=mesh)
    enabledKeys = settings.enabledMetadataKeys()
    chunkTimer = timing.IntervalTimer(3600)
    perfTimer = timing.IntervalTimer(60)
    from ..utils.profiling import TracemallocReporter
    memReporter = TracemallocReporter()   # ODW_TRACEMALLOC=<s> enables

    # ---- histogram-first recording: on-device accumulation state ----
    histMode = recording == 'histogram' and mode in ('true', 'pseudo')
    histSteps, histMeta, histSpec = {}, None, None
    histFlushTimer = timing.IntervalTimer(flushEverySeconds)
    if histMode:
      from ..tracing import fused as fusedMod
      histSpec = fusedMod.makeHistogramSpec(run.device, run.info,
                                            bounds=histBounds,
                                            bins=histBins)
      histMeta = dict(bounds=np.asarray(histSpec['bounds']),
                      detLabels=histSpec['detLabels'])

    def buildHistStep(src, n):
      from ..tracing import fused as fusedMod
      sc = run.sceneFor(src)
      maxI = max(1, int(round(settings.maxIntersections()
                              * float(src.MaxIntersectionsScale))))
      kwargs = dict(raysPerStep=n, maxIntersections=maxI,
                    maxRayLength=settings.maxRayLength()
                    * float(src.MaxRayLengthScale),
                    distTol=settings.deviceDistanceTolerance(),
                    stratified=(mode == 'pseudo'))
      if run.mesh is not None:
        from ..parallel import makeShardedFusedStep
        return makeShardedFusedStep(run.mesh, sc, src.deviceGenerator(),
                                    histSpec, **kwargs)
      return fusedMod.makeFusedStep(sc, src.deviceGenerator(), histSpec,
                                    **kwargs)

    def flushHistograms():
      for label, hist in hists.items():
        results.writeHistogramSnapshot(
            label, dict(power=np.asarray(hist['power']),
                        counts=np.asarray(hist['counts'])), histMeta)

    def storeHits(srcLabel, hits):
      '''One stored-hit schema for every path (raw/sampled/slow).'''
      for label, cols in hits.items():
        meta = {k: v for k, v in cols.items()
                if k not in ('points', 'directions', 'powers',
                             'isEntering')}
        results.addHitBatch(srcLabel, label, cols['points'],
                            cols['directions'], cols['powers'],
                            cols['isEntering'], meta)

    # sources that trace un-windowed (host fans/meshes): windowed step
    # dispatch must then stay at 1 step/pass or the per-iteration sampling
    # balance across sources skews vs the reference's loop semantics
    anyHostSource = any(
        not src.supportsDeviceSampling() for src in scene.lightSources()
        if isinstance(src, PointSource) or hasattr(src, 'generateRays'))

    for src in scene.lightSources():
      src.onInitializeSimulation(state='pre-worker-launch', ident=action)

    iteration = 0
    while True:
      iteration += 1
      # iteration accounting for windowed histogram dispatch: the window is
      # shared across sources (one loop pass advances every source), so the
      # extra iterations counted per pass are the MAX inner window over the
      # sources, not their sum
      passExtraIters = 0
      for src in scene.lightSources():
        if not isinstance(src, PointSource) and not hasattr(
            src, 'generateRays'):
          continue
        # ---- histogram-first fast path (any source with a device
        # generator: point sources AND surface sources) ----
        if histMode and drawn is None and src.supportsDeviceSampling():
          from ..tracing import fused as fusedMod
          n = max(1, int(round(settings.raysPerIteration()
                               * float(src.RaysPerIterationScale))))
          step = histSteps.get(src.Label)
          if step is None:
            step = histSteps[src.Label] = buildHistStep(src, n)
            hists[src.Label] = fusedMod.initHistograms(histSpec)
          # dispatch a WINDOW of steps and fetch the hit counter once: the
          # steps queue on the device back to back and the host waits for
          # the device once per window instead of once per step
          if not continuous or anyHostSource:
            inner = 1     # keep per-pass sampling balanced across sources
          elif np.isfinite(results.endAfterRays):
            remaining = results.endAfterRays - results.totalTracedRays
            inner = int(np.clip(np.ceil(remaining / n), 1, 16))
          else:
            inner = 16
          if np.isfinite(results.endAfterIterations):
            inner = int(np.clip(results.endAfterIterations
                                - results.totalIterations, 1, inner))
          if np.isfinite(results.endAfterHits):
            inner = min(inner, 4)     # bound the overshoot past the target
          hitAcc = None
          for _ in range(inner):
            key, sub = jax.random.split(key)
            hists[src.Label], counters = step(sub, hists[src.Label])
            hitAcc = counters['hits'] if hitAcc is None \
                else hitAcc + counters['hits']
          results.incrementRayCount(n * inner)
          passExtraIters = max(passExtraIters, inner - 1)
          results.totalRecordedHits += int(hitAcc)
          # capped raw-hit sample for metadata-rich storage
          if store and rawSampleRays and iteration % rawSampleEvery == 1:
            gen = deviceGens.get(src.Label)
            if gen is None:
              gen = deviceGens[src.Label] = src.deviceGenerator()
            key, sub2 = jax.random.split(key)
            batch = gen(sub2, rawSampleRays, stratified=(mode == 'pseudo'))
            key, traceKey = jax.random.split(key)
            _state, records = run.traceBatch(src, batch, False,
                                             key=traceKey)
            metadata = {k: np.asarray(v)
                        for k, v in batch.get('metadata', {}).items()}
            sampleHits = compactRecordsToHits(
                records, metadata, run.info['elementLabels'],
                enabledKeys=enabledKeys or None)
            storeHits(src.Label, sampleHits)
          if store and histFlushTimer.check():
            flushHistograms()
          continue

        # ---- generate rays ----
        if mode in ('true', 'pseudo') and src.supportsDeviceSampling():
          n = max(1, int(round(settings.raysPerIteration()
                               * float(src.RaysPerIterationScale))))
          if run.mesh is not None:
            n = -(-n // run.mesh.size) * run.mesh.size

          gen = deviceGens.get(src.Label)
          if gen is None:
            gen = deviceGens[src.Label] = src.deviceGenerator()
          key, sub = jax.random.split(key)
          batch = gen(sub, n, stratified=(mode == 'pseudo'))
        else:
          batch = src.generateRays(mode, settings=settings)
          if isWorker and not continuous and workerCount > 1:
            # deterministic work split across OS workers: each worker keeps
            # the strided slice [workerIndex::workerCount] of the fan's
            # initial conditions — the host analog of the reference's
            # initial-conditions file queue (results_store.py:679-738,
            # simulation_loop.py:640-666); strided so every worker sees
            # every fan (ray counts per fan need not divide workerCount)
            batch = _sliceBatch(batch, workerIndex, workerCount)
          n = len(batch['origins'])
          if n == 0:
            continue

        # ---- trace ----
        recordSegs = bool(src.RecordRays) or drawn is not None
        key, traceKey = jax.random.split(key)
        state, records = run.traceBatch(src, batch, recordSegs,
                                        key=traceKey)
        results.incrementRayCount(n)
        if drawn is not None:
          drawn.add(records, sourceLabel=src.Label,
                    sourceColor=getattr(src, 'ViewColor', (1., 0., 0.)),
                    **drawParams)

        # ---- record ----
        if store:
          metadata = {k: np.asarray(v)
                      for k, v in batch.get('metadata', {}).items()}
          # fan indices are always stored when present (reference stores
          # them via StoreHit* flags; fan analysis needs them)
          hits = compactRecordsToHits(
              records, metadata, run.info['elementLabels'],
              enabledKeys=None if not enabledKeys
              else enabledKeys + ['fanindex', 'rayindex',
                                  'totalfancount', 'totalraysinfan'])
          storeHits(src.Label, hits)
          if recordSegs:
            rays = recordsToRays(records, run.info['elementLabels'])
            if rays is not None:
              results.addRayBatch(src.Label, **rays)
        else:
          # still count hits for end criteria / progress
          results.totalRecordedHits += int(
              np.asarray(records['recordHit']).sum())

      results.incrementIterationCount(1 + passExtraIters)
      results.writeDiskIfNeeded()
      if isWorker:
        # worker: atomic progress dumps for the master to consume+sum
        # (reference: results_store.py:462-480); exit on the master's
        # flags or a dead parent (simulation_loop.py:571-577)
        results.dumpProgressIfNeeded(workerId=workerId)
        if parentPid is not None:
          try:
            os.kill(int(parentPid), 0)
          except OSError:
            io.warn('parent process died; worker exiting')
            break
        if lifecycle.isCanceled() or lifecycle.isFinished():
          break
        if not continuous:
          break
        continue
      progress = results.getProgress()
      if progressCallback is not None:
        progressCallback(progress)
      if endIf is not None and endIf(results.runPath()):
        lifecycle.setIsFinished(True)
      if perfTimer.check():
        io.info(results.performanceDescription())
      memReporter.maybeReport()
      if chunkTimer.check():
        try:
          results_store.chunkFiles(results.runPath())
        except Exception as e:
          io.warn(f'result-file chunking failed (run continues): {e}')
      lifecycle.touchRunning()
      if progress['reachedEnd'] or lifecycle.isCanceled() \
          or lifecycle.isFinished():
        break
      if not continuous:
        break
  except SimulationEnded:
    pass
  finally:
    _inCleanup[0] = True
    if results is not None:
      try:
        if store and hists:
          flushHistograms()
      except Exception as e:
        io.warn(f'final histogram flush failed: {e}')
      if drawn is not None and drawn.rayCount:
        try:
          drawn.save(results.runPath())
        except Exception as e:
          io.warn(f'writing drawn rays failed: {e}')
      if isWorker:
        try:
          results.dumpProgress(workerId=workerId)    # final cumulative dump
        except Exception:
          pass
      results.cleanup()
      io.info(f'simulation ended: {results.performanceDescription()}')
    for src in scene.lightSources():
      src.onExitSimulation(ident=action)
    if not isWorker:
      lifecycle.setIsFinished(True)
      lifecycle.setIsRunning(False)
      lifecycle.setIsCanceled(False)
      io.gatherWorkerLogs()
    if _prevSigterm is not None:
      import signal as _signal
      try:
        _signal.signal(_signal.SIGTERM, _prevSigterm)
      except ValueError:
        pass
  return results.runPath()


def runAction(scene, action, **kwargs):
  '''Parity wrapper (reference: simulation_loop.py:275-289).'''
  return runSimulation(scene, action, **kwargs)
