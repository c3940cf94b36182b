'''
ctypes bindings for the native async columnar store writer
(native/odw_store.cpp), with a pure-python fallback. The `.odwc` format is
a raw little-endian columnar container:

  magic 'ODWC1\\n' | u32 ncols | per column:
    u16 nameLen | name | u8 dtypeChar | u8 ndim | u64 shape[ndim] | raw data

dtype chars: 'f' float32, 'd' float64, 'i' int64, 'b' uint8, 'U' unicode
(object/string columns are encoded as fixed-width UTF-32 like numpy '<U').
'''

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from . import io

_DTYPE_TO_CHAR = {'float32': 'f', 'float64': 'd', 'int64': 'i',
                  'uint8': 'b'}
_CHAR_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CHAR.items()}

_lib = None
_libLock = threading.Lock()
_buildFailed = False


def _sourcePath():
  return os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), 'native', 'odw_store.cpp')


def _libPath():
  cache = os.environ.get('ODW_NATIVE_CACHE',
                         os.path.join(tempfile.gettempdir(),
                                      'odw_native'))
  os.makedirs(cache, exist_ok=True)
  return os.path.join(cache, 'libodwstore.so')


def loadNativeLib():
  '''Load (building on first use) the native writer; returns None when no
  C++ toolchain is available.'''
  global _lib, _buildFailed
  if _lib is not None or _buildFailed:
    return _lib
  with _libLock:
    if _lib is not None or _buildFailed:
      return _lib
    libPath = _libPath()
    src = _sourcePath()
    if (not os.path.exists(libPath)
        or os.path.getmtime(libPath) < os.path.getmtime(src)):
      try:
        subprocess.run(['g++', '-O2', '-shared', '-fPIC', '-std=c++17',
                        '-o', libPath + '.build', src, '-pthread'],
                       check=True, capture_output=True)
        os.replace(libPath + '.build', libPath)
      except Exception as e:
        io.warn(f'native store writer unavailable (g++ build failed: {e}); '
                f'falling back to pure-python writes')
        _buildFailed = True
        return None
    try:
      lib = ctypes.CDLL(libPath)
      lib.odw_write.restype = ctypes.c_int
      lib.odw_spool_submit.restype = ctypes.c_int
      lib.odw_spool_drain.restype = ctypes.c_int64
      lib.odw_spool_pending.restype = ctypes.c_int64
      _lib = lib
    except OSError as e:
      io.warn(f'failed to load native store writer: {e}')
      _buildFailed = True
  return _lib


def _normalizeColumn(v):
  v = np.ascontiguousarray(v)
  if v.dtype == np.float32 or v.dtype == np.float64 \
     or v.dtype == np.int64 or v.dtype == np.uint8:
    return v
  if v.dtype == bool or v.dtype == np.int8:
    return v.astype(np.uint8)
  if np.issubdtype(v.dtype, np.integer):
    return v.astype(np.int64)
  if np.issubdtype(v.dtype, np.floating):
    return v.astype(np.float64)
  if v.dtype.kind in ('U', 'S', 'O'):
    return v.astype('U')
  raise TypeError(f'unsupported column dtype {v.dtype}')


def _prepareArgs(path, columns):
  names, dtypes, ndims, shapes, ptrs, nbytes, keepAlive = \
      [], [], [], [], [], [], []
  for name, v in columns.items():
    v = _normalizeColumn(v)
    keepAlive.append(v)
    names.append(name.encode())
    if v.dtype.kind == 'U':
      dtypes.append(b'U')
      # store itemsize (chars) as the trailing shape entry
      shp = list(v.shape) + [v.dtype.itemsize // 4]
    else:
      dtypes.append(_DTYPE_TO_CHAR[v.dtype.name].encode())
      shp = list(v.shape)
    ndims.append(len(shp))
    shapes.extend(shp)
    ptrs.append(v.ctypes.data_as(ctypes.c_void_p))
    nbytes.append(v.nbytes)
  ncols = len(names)
  cNames = (ctypes.c_char_p * ncols)(*names)
  cDtypes = ctypes.c_char_p(b''.join(dtypes))
  cNdims = (ctypes.c_int64 * ncols)(*ndims)
  cShapes = (ctypes.c_int64 * len(shapes))(*shapes)
  cPtrs = (ctypes.c_void_p * ncols)(*[p.value for p in ptrs])
  cNbytes = (ctypes.c_int64 * ncols)(*nbytes)
  return (path.encode(), ncols, cNames, cDtypes, cNdims, cShapes, cPtrs,
          cNbytes), keepAlive


def writeColumns(path, columns, asynchronous=True):
  '''Write a dict of numpy columns to `path` as .odwc. Uses the native
  background spool when available (the simulation loop never blocks on
  disk), else writes synchronously in python.'''
  lib = loadNativeLib()
  if lib is not None:
    args, _keep = _prepareArgs(path, columns)
    fn = lib.odw_spool_submit if asynchronous else lib.odw_write
    rc = fn(*args)
    if rc != 0:
      raise OSError(f'native store write failed with code {rc} for {path}')
    return
  _writeColumnsPython(path, columns)


def drain():
  '''Block until all spooled writes are on disk; raise if any failed.'''
  lib = loadNativeLib()
  if lib is None:
    return
  errors = lib.odw_spool_drain()
  if errors:
    raise OSError(f'{errors} native store write(s) failed')


def _writeColumnsPython(path, columns):
  import io as _io
  buf = _io.BytesIO()
  buf.write(b'ODWC1\n')
  buf.write(np.uint32(len(columns)).tobytes())
  for name, v in columns.items():
    v = _normalizeColumn(v)
    nameB = name.encode()
    buf.write(np.uint16(len(nameB)).tobytes())
    buf.write(nameB)
    if v.dtype.kind == 'U':
      buf.write(b'U')
      shp = list(v.shape) + [v.dtype.itemsize // 4]
    else:
      buf.write(_DTYPE_TO_CHAR[v.dtype.name].encode())
      shp = list(v.shape)
    buf.write(np.uint8(len(shp)).tobytes())
    for s in shp:
      buf.write(np.uint64(s).tobytes())
    buf.write(v.tobytes())
  io.atomicWrite(path, buf.getvalue())


def readColumns(path):
  '''Read an .odwc file into a dict of numpy arrays.'''
  with open(path, 'rb') as f:
    raw = f.read()
  if raw[:6] != b'ODWC1\n':
    raise ValueError(f'{path} is not an ODWC file')
  off = 6
  ncols = int(np.frombuffer(raw, np.uint32, 1, off)[0])
  off += 4
  out = {}
  for _ in range(ncols):
    nameLen = int(np.frombuffer(raw, np.uint16, 1, off)[0])
    off += 2
    name = raw[off:off + nameLen].decode()
    off += nameLen
    dtypeChar = chr(raw[off])
    off += 1
    ndim = raw[off]
    off += 1
    shape = [int(s) for s in np.frombuffer(raw, np.uint64, ndim, off)]
    off += 8 * ndim
    if dtypeChar == 'U':
      chars = shape[-1]
      shape = shape[:-1]
      count = int(np.prod(shape)) if shape else 1
      v = np.frombuffer(raw, f'<U{chars}', count, off).reshape(shape)
      off += count * chars * 4
    else:
      dtype = np.dtype(_CHAR_TO_DTYPE[dtypeChar])
      count = int(np.prod(shape)) if shape else 1
      v = np.frombuffer(raw, dtype, count, off).reshape(shape)
      off += count * dtype.itemsize
    out[name] = v
  return out
