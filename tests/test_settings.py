'''
Settings semantics tests (reference: simulation_settings.py:20-151,
test/21-simulation-modes worker-count parametrization).
'''

import numpy as np
import pytest

from optics_design_workbench.models import (Scene, SimulationSettings,
                                            PointSource, OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation


class TestWorkerCount:

  @pytest.mark.parametrize('raw,expected', [
      ('num_cpus', 8), (1, 1), (2, 2), (4, 4),
      (-5, 3),            # negative = devices + count (8 - 5)
      (0, 8),             # clamped into [1, 10*devices]; 0 -> devices
      (1000, 80),         # clamped to 10*devices
  ])
  def test_worker_count_parsing(self, raw, expected):
    s = SimulationSettings(WorkerProcessCount=raw)
    assert s.workerCount(deviceCount=8) == expected

  def test_worker_count_sharded_run(self, tmp_path):
    # explicit WorkerProcessCount=4 shards the batch over 4 CPU devices
    scene = Scene(label='wc', path=str(tmp_path / 'wc'))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='D',
        surfaces=[S.plane(np.eye(4), elem=0, radius=100.)],
        placements=[T.translation(0, 0, 10)]))
    scene.addSource(PointSource(Label='S',
                                PowerDensity='exp(-theta^2/0.01)',
                                ThetaDomain='0, 0.3',
                                ThetaResolutionNumericMode='2e3'))
    scene.addSimulationSettings(RaysPerIteration=4000,
                                WorkerProcessCount=4,
                                EnableStoreSingleShotData=True)
    runPath = simulation.runSimulation(scene, 'singletrue', seed=1)
    from optics_design_workbench.jupyter_utils import RawFolder
    hits = RawFolder(runPath).loadHits('D')
    assert len(hits) >= 3900


class TestParsedValues:

  def test_string_numerics(self):
    s = SimulationSettings(EndAfterRays='1e5', EndAfterHits='inf',
                           DistanceTolerance='1e-3', MaxIntersections=7)
    assert s.endAfterRays() == 1e5
    assert s.endAfterHits() == np.inf
    assert s.distanceTolerance() == 1e-3
    assert s.maxIntersections() == 7

  def test_distance_tolerance_clamped(self):
    assert SimulationSettings(
        DistanceTolerance='1e-15').distanceTolerance() == 1e-9
    assert SimulationSettings(
        DistanceTolerance='100').distanceTolerance() == 1.

  def test_exactly_one_active(self, tmp_path):
    scene = Scene(label='a', path=str(tmp_path / 'a'))
    s1 = scene.addSimulationSettings(EndAfterRays='1')
    s2 = scene.addSimulationSettings(EndAfterRays='2')
    assert not s1.Active and s2.Active
    assert scene.activeSimulationSettings() is s2

  def test_enabled_metadata_keys(self):
    s = SimulationSettings(StoreHitInitPhi=True, StoreHitFanIndex=True)
    keys = s.enabledMetadataKeys()
    assert 'initphi' in keys and 'fanindex' in keys
    assert 'inittheta' not in keys


def test_device_distance_tolerance_floor():
  '''The float32 device tracers never use a tolerance below 1e-4 mm (a
  smaller one lets rays re-hit the face they just left); larger settings
  pass through unchanged.'''
  assert SimulationSettings().deviceDistanceTolerance() == 1e-4
  assert SimulationSettings(
      DistanceTolerance='1e-3').deviceDistanceTolerance() == 1e-3
