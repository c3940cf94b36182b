'''
Spectrometer-config parity test (BASELINE.md config 4, docs
example-spectrometer.rst): a reflection grating resolves wavelengths onto
the detector at positions given by the grating equation.
'''

import importlib.util
import os

import numpy as np

from optics_design_workbench import simulation
from optics_design_workbench.jupyter_utils import RawFolder

_spec = importlib.util.spec_from_file_location(
    'example4', os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'examples', '4_spectrometer.py'))
example4 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(example4)


def test_spectral_lines_match_grating_equation(tmp_path):
  scene = example4.buildScene(path=str(tmp_path / 'spectro'),
                              wavelengths=(450., 550., 650.))
  runPath = simulation.runSimulation(scene, 'singletrue', seed=4)
  raw = RawFolder(runPath)
  positions = {}
  for wl in (450, 550, 650):
    hits = raw.loadHits('Detector', source=f'Source{wl}')
    assert len(hits) > 10000
    pts = hits.points()
    positions[wl] = float(np.hypot(pts[:, 0], pts[:, 1]).mean())
    expected = example4.expectedPosition(wl)
    assert abs(positions[wl] - expected) < 0.15, \
        f'{wl} nm at {positions[wl]:.2f}, expected {expected:.2f}'
  # monotone dispersion
  assert positions[450] < positions[550] < positions[650]


def test_throughput_meter():
  from optics_design_workbench.utils.profiling import ThroughputMeter
  m = ThroughputMeter()
  m.update(rays=1000, segments=4000, hits=900)
  desc = m.description()
  assert 'rays/hour' in desc and 'segments/s' in desc
