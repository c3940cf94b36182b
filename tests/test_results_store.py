'''
Results-store regression tests: chunk merging keeps data visible across
repeated merges, progress aggregation keys workers stably and prunes master
snapshots, and the sympy timeout guard never fires outside its region.
(reference semantics: simulation/results_store.py:74-181, 462-603.)
'''

import os
import pickle
import time

import numpy as np
import pytest

from optics_design_workbench.simulation import results_store
from optics_design_workbench.utils import native_store


def _makeStore(tmp_path, **kw):
  return results_store.SimulationResults(
      simulationType='true', basePath=str(tmp_path / 'x.OpticsDesign'),
      simulationRunFolder='raw/simulation-run-000000', **kw)


def _addHits(store, n, src='S', obj='D'):
  store.addHitBatch(src, obj, np.random.rand(n, 3), np.random.rand(n, 3),
                    np.ones(n), np.ones(n, dtype=np.int8),
                    {'initTheta': np.random.rand(n)})


def _visibleRows(runPath):
  total = 0
  for folder, _d, _f in os.walk(runPath):
    for p in results_store.resultFilePaths(folder, 'hits'):
      total += len(results_store.loadResultFile(p)['points'])
  return total


def test_chunk_files_twice_keeps_data_visible(tmp_path):
  '''Re-merging chunks must not produce a -chunk-chunk name that the loader
  globs never match (round-1 advisor finding: data silently vanished after
  the second hourly merge).'''
  store = _makeStore(tmp_path)
  for _ in range(3):
    _addHits(store, 5)
    store.flush()
    time.sleep(.01)
  store.cleanup()
  run = store.runPath()
  assert _visibleRows(run) == 15
  # first merge
  merged = results_store.chunkFiles(run, olderThanSeconds=0)
  assert merged == 3
  assert _visibleRows(run) == 15
  # add more files and merge again — the chunk from merge 1 participates
  store2 = _makeStore(tmp_path)
  for _ in range(2):
    _addHits(store2, 5)
    store2.flush()
    time.sleep(.01)
  store2.cleanup()
  assert _visibleRows(run) == 25
  results_store.chunkFiles(run, olderThanSeconds=0)
  assert _visibleRows(run) == 25
  # and a third time, exercising chunk+chunk merging
  results_store.chunkFiles(run, olderThanSeconds=0)
  assert _visibleRows(run) == 25
  for folder, _d, files in os.walk(run):
    for f in files:
      assert '-chunk-chunk' not in f, f


def test_chunk_files_pads_multidim_metadata(tmp_path):
  '''A (n, 3) metadata column missing from one file must nan-pad with the
  full trailing shape instead of crashing np.concatenate.'''
  store = _makeStore(tmp_path)
  store.addHitBatch('S', 'D', np.zeros((4, 3)), np.zeros((4, 3)),
                    np.ones(4), np.ones(4, dtype=np.int8),
                    {'extra3d': np.zeros((4, 3))})
  store.flush()
  time.sleep(.01)
  store.addHitBatch('S', 'D', np.zeros((2, 3)), np.zeros((2, 3)),
                    np.ones(2), np.ones(2, dtype=np.int8))
  store.flush()
  store.cleanup()
  results_store.chunkFiles(store.runPath(), olderThanSeconds=0)
  run = store.runPath()
  assert _visibleRows(run) == 6
  for folder, _d, _f in os.walk(run):
    for p in results_store.resultFilePaths(folder, 'hits'):
      d = results_store.loadResultFile(p)
      assert d['extra3d'].shape == (6, 3)
      assert np.isnan(d['extra3d'][-2:]).all()


def test_progress_worker_keying_replaces_not_sums(tmp_path):
  '''Repeated cumulative dumps from one worker must REPLACE its entry, not
  accumulate (reference keys by pid: results_store.py:558-599).'''
  worker = _makeStore(tmp_path)
  master = _makeStore(tmp_path)
  worker.totalTracedRays = 100
  worker.dumpProgress()
  time.sleep(.01)
  worker.totalTracedRays = 250
  worker.dumpProgress()
  total = master.getProgress()
  assert total['totalTracedRays'] == 250, \
      'cumulative worker dumps were summed instead of replaced'
  # explicit workerId keying too
  worker.totalTracedRays = 400
  worker.dumpProgress(workerId='w7')
  time.sleep(.01)
  worker.totalTracedRays = 500
  worker.dumpProgress(workerId='w7')
  total = master.getProgress()
  # 250 entry (pid-keyed) was already consumed&retained; w7 adds 500
  assert total['totalTracedRays'] == 750


def test_master_progress_throttled_and_pruned(tmp_path):
  '''Master snapshots are throttled to ~0.5 s and old ones pruned, so
  progress/ cannot grow without bound (round-1 advisor finding).'''
  store = _makeStore(tmp_path)
  for _ in range(20):
    store.getProgress()
  folder = os.path.join(store.runPath(), 'progress')
  masters = [f for f in os.listdir(folder) if f.startswith('master-')]
  assert len(masters) <= 2
  # snapshot content is a valid progress dict
  with open(os.path.join(folder, sorted(masters)[-1]), 'rb') as f:
    data = pickle.load(f)
  assert 'totalTracedRays' in data and 'reachedEnd' in data


def test_native_drain_under_many_jobs(tmp_path):
  '''Spool many small writes then drain; exercises the final-notify ordering
  (lost-wakeup fix in odw_store.cpp workerLoop).'''
  lib = native_store.loadNativeLib()
  if lib is None:
    pytest.skip('no native toolchain')
  for i in range(200):
    native_store.writeColumns(str(tmp_path / f'f{i:03d}.odwc'),
                              {'a': np.arange(10.)}, asynchronous=True)
  t0 = time.time()
  native_store.drain()
  assert time.time() - t0 < 30
  assert len(list(tmp_path.glob('f*.odwc'))) == 200
  d = native_store.readColumns(str(tmp_path / 'f199.odwc'))
  assert np.allclose(d['a'], np.arange(10.))


def test_timeout_never_fires_outside_region():
  '''A _Timeout whose deadline passes must not leave a live alarm behind:
  after the with-block, no KeyboardInterrupt may hit unrelated code
  (round-1: a late SIGALRM aborted pytest from inside an XLA GC callback).'''
  import signal
  from optics_design_workbench.distributions.random_variables import \
      _Timeout

  with pytest.raises(RuntimeError, match='time is up'):
    with _Timeout(time.thread_time() + .2):   # CPU-time budget
      t0 = time.time()
      while time.time() - t0 < 4:   # hung-solve stand-in (burns CPU)
        pass
  # region exited: wait past any would-be re-arm; nothing may fire
  time.sleep(.6)
  assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)

  # a timeout that never triggers restores the previous handler
  prev = signal.signal(signal.SIGALRM, signal.SIG_IGN)
  try:
    with _Timeout(time.thread_time() + 60):
      pass
    assert signal.getsignal(signal.SIGALRM) is signal.SIG_IGN
  finally:
    signal.signal(signal.SIGALRM, prev)


def test_timeout_budget_is_cpu_time_not_wall_clock():
  '''Wall-clock time passing WITHOUT main-thread CPU use (sleep = stand-in
  for machine load starving the process) must not expire the budget — the
  round-2 flake was the analytic sympy budget expiring under load and
  silently flipping compile mode to numeric.'''
  from optics_design_workbench.distributions.random_variables import \
      _Timeout

  with _Timeout(time.thread_time() + 1.5):
    time.sleep(2.5)        # more wall time than the whole CPU budget
  # no RuntimeError: the guard re-armed instead of firing


def test_histogram_snapshots_sum_across_workers(tmp_path):
  '''Per-worker histogram snapshots: each worker's snapshots are cumulative
  and supersede only its OWN older files; the loader sums the latest
  snapshot per worker (round-2 bug: writeHistogramSnapshot deleted ALL
  snapshots in the folder and the loader read only the newest file, so
  concurrent workers clobbered each other and only the last flusher's
  counts survived).'''
  import threading

  store = results_store.SimulationResults(
      simulationType='true', basePath=str(tmp_path),
      simulationRunFolder='raw/simulation-run-000000')
  meta = dict(bounds=np.array([[0., 1., 0., 1.]]), detLabels=['Det'])

  def worker(value, flushes):
    # each flush is CUMULATIVE for this worker (thread = distinct key)
    for i in range(1, flushes + 1):
      store.writeHistogramSnapshot(
          'Src', dict(power=np.full((1, 4, 4), value * i),
                      counts=np.full((1, 4, 4), value * i)), meta)
      time.sleep(.01)

  threads = [threading.Thread(target=worker, args=(v, 3))
             for v in (1., 10.)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  # main thread acts as a third worker
  worker(100., 2)

  out = results_store.loadHistogramSnapshots(store.runPath())
  counts = out['Src']['Det']['counts']
  # latest per worker: 3*1 + 3*10 + 2*100 = 233 in every bin
  assert np.allclose(counts, 233.)
  srcFolder = os.path.join(store.runPath(), 'source-Src')
  import glob as _glob
  files = _glob.glob(os.path.join(srcFolder, '*-histograms.npz'))
  assert len(files) == 3      # exactly one surviving file per worker


def test_reference_pkl_hit_files_load(tmp_path):
  '''A reference-era run folder (pickled columnar hit dicts named
  <ts>-pid-thread-hits.pkl, reference results_store.py:399-453) loads
  through loadResultFile/resultFilePaths unchanged, so migrating users
  can point loaders and ReplaySource at existing folders.'''
  folder = tmp_path / 'source-S' / 'object-D'
  folder.mkdir(parents=True)
  payload = dict(source='S', obj='D',
                 points=np.array([[0., 1., 2.], [3., 4., 5.]]),
                 directions=np.array([[0., 0., 1.], [0., 0., 1.]]),
                 powers=np.array([1., .5]),
                 isEntering=np.array([1, 0]),
                 initTheta=np.array([.1, np.nan]))
  path = folder / '123-pid1-thread2-hits.pkl'
  with open(path, 'wb') as f:
    pickle.dump(payload, f)
  found = results_store.resultFilePaths(str(folder), 'hits')
  assert str(path) in found
  data = results_store.loadResultFile(str(path))
  assert data['source'] == 'S' and data['obj'] == 'D'
  np.testing.assert_allclose(data['points'], payload['points'])
  np.testing.assert_allclose(data['powers'], [1., .5])


def test_robust_unpickler_tolerates_numpy_module_rename(tmp_path):
  '''Pickles referencing the numpy module path this numpy does NOT use
  (core vs _core) still load (reference: io.py:242-249).'''
  import numpy as _np
  from optics_design_workbench.utils import io as tio
  # protocol 0 writes module paths as newline-delimited text (no frame
  # length prefixes), so the rename can be spliced in byte-for-byte
  raw = pickle.dumps(dict(a=_np.arange(4.), b=_np.array([[1, 2]])),
                     protocol=0)
  real = b'numpy._core' if _np.__version__.startswith('2') else b'numpy.core'
  other = b'numpy.core' if real == b'numpy._core' else b'numpy._core'
  swapped = raw.replace(real + b'\n', other + b'\n')
  p = tmp_path / 'renamed.pkl'
  p.write_bytes(swapped)
  data = tio.unpickle(str(p))
  np.testing.assert_allclose(data['a'], _np.arange(4.))


def test_replay_source_reads_reference_pkl(tmp_path):
  '''ReplaySource replays a folder of reference-written -hits.pkl files
  (reference: replay_source.py:73-113).'''
  from optics_design_workbench.models.replay_source import ReplaySource
  folder = tmp_path / 'run' / 'source-S' / 'object-D'
  folder.mkdir(parents=True)
  pts = np.array([[0., 0., 0.], [1., 0., 0.]])
  dirs = np.array([[0., 0., 1.], [0., 0., 1.]])
  with open(folder / '9-pid1-thread1-hits.pkl', 'wb') as f:
    pickle.dump(dict(source='S', obj='D', points=pts, directions=dirs,
                     powers=np.array([2., 3.])), f)
  src = ReplaySource(Label='rp', ReplayFromDir=str(tmp_path / 'run'),
                     Wavelength=532.)
  batch = src.generateRays('true', rng=np.random.default_rng(0))
  assert batch['origins'].shape == (2, 3)
  assert sorted(np.asarray(batch['powers']).tolist()) == [2., 3.]
