'''
Native async columnar store writer tests (native/odw_store.cpp +
utils/native_store.py).
'''

import numpy as np
import pytest

from optics_design_workbench.utils import native_store


COLUMNS = dict(
    points=np.random.default_rng(0).normal(size=(1000, 3)).astype(np.float32),
    powers=np.random.default_rng(1).random(1000),
    isEntering=np.arange(1000, dtype=np.int64) % 2,
    flags=(np.arange(1000) % 3 == 0),
    media=np.array(['Lens', 'None', 'Detector'] * 100),
    source=np.str_('Source'),
)


def _roundtrip(tmp_path, asynchronous):
  path = str(tmp_path / f'test-{asynchronous}.odwc')
  cols = dict(COLUMNS)
  cols['source'] = np.asarray(cols['source'])
  native_store.writeColumns(path, cols, asynchronous=asynchronous)
  native_store.drain()
  out = native_store.readColumns(path)
  assert set(out) == set(cols)
  np.testing.assert_allclose(out['points'], cols['points'])
  np.testing.assert_allclose(out['powers'], cols['powers'])
  assert (out['isEntering'] == cols['isEntering']).all()
  assert (out['flags'].astype(bool) == cols['flags']).all()
  assert list(out['media'][:3]) == ['Lens', 'None', 'Detector']


def test_native_roundtrip_sync(tmp_path):
  if native_store.loadNativeLib() is None:
    pytest.skip('no C++ toolchain')
  _roundtrip(tmp_path, asynchronous=False)


def test_native_roundtrip_async(tmp_path):
  if native_store.loadNativeLib() is None:
    pytest.skip('no C++ toolchain')
  _roundtrip(tmp_path, asynchronous=True)


def test_python_fallback_roundtrip(tmp_path):
  path = str(tmp_path / 'py.odwc')
  cols = {k: np.asarray(v) for k, v in COLUMNS.items()}
  native_store._writeColumnsPython(path, cols)
  out = native_store.readColumns(path)
  np.testing.assert_allclose(out['points'], cols['points'])
  assert list(out['media'][:3]) == ['Lens', 'None', 'Detector']


def test_many_async_writes_drain(tmp_path):
  if native_store.loadNativeLib() is None:
    pytest.skip('no C++ toolchain')
  import os
  for i in range(50):
    native_store.writeColumns(str(tmp_path / f'f{i}.odwc'),
                              dict(x=np.full(1000, i, dtype=np.float32)))
  native_store.drain()
  files = sorted(os.listdir(tmp_path))
  assert len([f for f in files if f.endswith('.odwc')]) == 50
  out = native_store.readColumns(str(tmp_path / 'f17.odwc'))
  assert out['x'][0] == 17.


def test_store_format_integration(tmp_path):
  '''SimulationResults with the odwc format writes native files the loaders
  read back.'''
  from optics_design_workbench.simulation import results_store as RS
  results = RS.SimulationResults(
      'true', str(tmp_path / 'x.OpticsDesign'), 'raw/simulation-run-000000',
      fileFormat='odwc')
  results.addHitBatch('Src', 'Det',
                      np.zeros((5, 3)), np.ones((5, 3)), np.ones(5),
                      np.zeros(5), dict(initTheta=np.arange(5.)))
  results.flush()
  results.cleanup()
  folder = str(tmp_path / 'x.OpticsDesign/raw/simulation-run-000000/'
               'source-Src/object-Det')
  files = RS.resultFilePaths(folder, 'hits')
  assert files and files[0].endswith(
      ('.odwc', '.npz'))   # odwc when toolchain available
  data = RS.loadResultFile(files[0])
  assert len(data['points']) == 5 and 'initTheta' in data
