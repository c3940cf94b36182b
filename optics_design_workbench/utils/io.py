'''
Logging and small IO helpers.

Covers the capability surface of the reference's `io.py` (reference:
freecad/optics_design_workbench/io.py:58-249): per-results-folder rotating
logfiles, master vs per-worker logfiles that are merged into the master log,
`err/warn/info/verb` message levels and `secondsToStr`. The FreeCAD/Qt and
pickle-compat machinery of the reference is not needed here; results are
stored in safe columnar formats (see simulation/results_store.py).
'''

import logging
import logging.handlers
import os
import sys
import time
import threading

_LOGGER_NAME = 'optics_design_workbench'
_logger = None
_logfilePath = None
_verbose = os.environ.get('ODW_VERBOSE', '') not in ('', '0', 'false')
_printLock = threading.Lock()


def _getLogger():
  global _logger
  if _logger is None:
    _logger = logging.getLogger(_LOGGER_NAME)
    _logger.setLevel(logging.DEBUG)
    _logger.propagate = False
    # prevent logging.lastResort double-printing before a file handler exists
    _logger.addHandler(logging.NullHandler())
  return _logger


def setLogfile(path, workerSuffix=None):
  '''
  Attach a rotating logfile to the logger. Master processes pass
  workerSuffix=None; worker processes pass a unique suffix (e.g. their pid)
  so their log lines end up in separate files that `gatherWorkerLogs` merges
  into the master log (reference: io.py:58-95, 122-157).
  '''
  global _logfilePath
  logger = _getLogger()
  for h in list(logger.handlers):
    logger.removeHandler(h)
    h.close()
  if workerSuffix is not None:
    base, ext = os.path.splitext(path)
    path = f'{base}.pid{workerSuffix}{ext or ".log"}'
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  handler = logging.handlers.RotatingFileHandler(
      path, maxBytes=50_000_000, backupCount=3)
  handler.setFormatter(logging.Formatter(
      '%(asctime)s %(levelname)-7s %(message)s'))
  logger.addHandler(handler)
  _logfilePath = path
  return path


def logfilePath():
  return _logfilePath


def gatherWorkerLogs(masterLogPath=None):
  '''
  Merge `<master>.pid<N>.log` files written by worker processes into the
  master logfile, prefixing each line with `(worker <pid>)`. Worker files
  are renamed to a temp name first so concurrent writers cannot race with
  the merge (reference: io.py:122-157).
  '''
  masterLogPath = masterLogPath or _logfilePath
  if not masterLogPath or not os.path.exists(os.path.dirname(os.path.abspath(masterLogPath))):
    return
  base, ext = os.path.splitext(masterLogPath)
  folder = os.path.dirname(os.path.abspath(masterLogPath))
  prefix = os.path.basename(base) + '.pid'
  for fn in sorted(os.listdir(folder)):
    if fn.startswith(prefix) and fn.endswith(ext or '.log') and not fn.endswith('.merging'):
      src = os.path.join(folder, fn)
      pid = fn[len(prefix):].split('.')[0]
      tmp = src + '.merging'
      try:
        os.rename(src, tmp)
      except OSError:
        continue
      try:
        with open(tmp) as f, open(masterLogPath, 'a') as out:
          for line in f:
            out.write(f'(worker {pid}) {line}')
        os.remove(tmp)
      except OSError:
        pass


def _emit(level, msg):
  logger = _getLogger()
  logger.log(level, msg)
  # echo to stderr for warnings/errors and, in verbose mode, for everything
  if level >= logging.WARNING or _verbose:
    with _printLock:
      print(f'{logging.getLevelName(level).lower()}: {msg}', file=sys.stderr)


def err(msg):
  _emit(logging.ERROR, msg)


def warn(msg):
  _emit(logging.WARNING, msg)


def info(msg):
  _emit(logging.INFO, msg)


def verb(msg):
  _emit(logging.DEBUG, msg)


def secondsToStr(seconds):
  '''Human readable duration, e.g. "1h 4m 12s" (reference: io.py:231).'''
  try:
    seconds = float(seconds)
  except (TypeError, ValueError):
    return '??'
  if seconds != seconds or seconds in (float('inf'), float('-inf')):
    return '??'
  sign = '-' if seconds < 0 else ''
  seconds = abs(seconds)
  if seconds < 1:
    return f'{sign}{seconds:.2g}s'
  parts = []
  for unit, span in (('d', 86400), ('h', 3600), ('m', 60)):
    if seconds >= span:
      parts.append(f'{int(seconds//span)}{unit}')
      seconds -= int(seconds // span) * span
    elif parts:
      parts.append(f'0{unit}')
  parts.append(f'{int(round(seconds))}s')
  return sign + ' '.join(parts[:2] if len(parts) > 2 else parts)


def atomicWrite(path, data):
  '''
  Write bytes to path atomically (write to temp file in same folder, fsync,
  rename). Replaces the reference's dependency on the `atomicwrites` package
  (reference: results_store.py:147).
  '''
  folder = os.path.dirname(os.path.abspath(path))
  os.makedirs(folder, exist_ok=True)
  tmp = os.path.join(folder, f'.tmp-{os.getpid()}-{threading.get_ident()}-{time.monotonic_ns()}')
  with open(tmp, 'wb') as f:
    f.write(data)
    f.flush()
    os.fsync(f.fileno())
  os.replace(tmp, path)


class RobustUnpickler:
  '''Unpickler tolerating numpy's `numpy.core` <-> `numpy._core` module
  rename, so result pickles written under one numpy major load under the
  other (reference: io.py:242-249 — the reference maps _core->core; both
  directions are tried here because this framework typically runs numpy>=2
  while reference-era run folders were written with numpy 1.x).'''

  def __init__(self, file):
    import pickle

    class _U(pickle.Unpickler):
      def find_class(self, module, name):
        candidates = [module]
        if module.startswith('numpy._core'):
          candidates.append('numpy.core' + module[len('numpy._core'):])
        elif module.startswith('numpy.core'):
          candidates.append('numpy._core' + module[len('numpy.core'):])
        for mod in candidates[:-1]:
          try:
            return super().find_class(mod, name)
          except (ImportError, AttributeError):
            continue
        return super().find_class(candidates[-1], name)

    self._u = _U(file)

  def load(self):
    return self._u.load()


def unpickle(fileOrPath):
  '''Load one pickle robustly (see RobustUnpickler). Accepts an open
  binary file or a path.'''
  if hasattr(fileOrPath, 'read'):
    return RobustUnpickler(fileOrPath).load()
  with open(fileOrPath, 'rb') as f:
    return RobustUnpickler(f).load()
