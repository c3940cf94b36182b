'''
End-to-end parity gate (SURVEY.md build step 6): the examples/1 analog —
Gaussian point source -> absorbing detector, Monte-Carlo and ray-fan modes,
hits recorded to disk under the reference's folder contract, spot
distribution matching the source density within MC error.
'''

import glob
import os
import pickle

import numpy as np
import pytest

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup,
                                            SimulationSettings)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation


@pytest.fixture
def sceneAndFolder(tmp_path):
  scene = Scene(label='example1', path=str(tmp_path / 'example1'))
  detector = OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.translation(0, 0, 100)])
  scene.addOpticalGroup(detector)
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', Wavelength=532.,
      ThetaResolutionNumericMode='2e4'))
  scene.addSimulationSettings(
      EndAfterRays='2e4', RaysPerIteration=5000, MaxIntersections=5,
      MaxRayLength=1000, EnableStoreSingleShotData=True)
  return scene, str(tmp_path / 'example1.OpticsDesign')


def loadAllHits(runPath, source='*', obj='*'):
  from optics_design_workbench.simulation import results_store as RS
  cols = None
  for folder in glob.glob(f'{runPath}/source-{source}/object-{obj}'):
    for f in RS.resultFilePaths(folder, 'hits'):
      data = RS.loadResultFile(f)
      if cols is None:
        cols = {k: [v] for k, v in data.items() if v.ndim > 0}
      else:
        for k in cols:
          cols[k].append(data[k])
  if cols is None:
    return None
  return {k: np.concatenate(v) for k, v in cols.items()}


class TestMonteCarloE2E:

  def test_continuous_true(self, sceneAndFolder):
    scene, folder = sceneAndFolder
    runPath = simulation.runSimulation(scene, 'true', seed=42)
    assert runPath and os.path.isdir(runPath)
    # folder contract
    assert os.path.isfile(os.path.join(folder, 'README.md'))
    assert any(f.startswith('uid-') for f in os.listdir(runPath))
    assert os.path.isfile(os.path.join(runPath, 'global-info.pkl'))
    with open(os.path.join(runPath, 'global-info.pkl'), 'rb') as f:
      info = pickle.load(f)
    assert 'Source' in info['sources'] and 'Detector' in info['opticalObjects']

    hits = loadAllHits(runPath, 'Source', 'Detector')
    assert hits is not None
    pts = hits['points']
    assert len(pts) >= 19000   # nearly all of the >=2e4 rays land on the det
    # all hits on detector plane z=100
    assert np.allclose(pts[:, 2], 100., atol=1e-3)
    # gaussian spot: radial distribution r = 100*tan(theta),
    # theta ~ exp(-theta^2/0.01)*sin(theta)
    r = np.hypot(pts[:, 0], pts[:, 1])
    theta = np.arctan(r / 100.)
    hist, edges = np.histogram(theta, bins=30, range=(0, 0.35),
                               density=True)
    centers = (edges[1:] + edges[:-1]) / 2
    expected = np.exp(-centers**2 / 0.01) * np.sin(centers)
    expected /= expected.sum() * (edges[1] - edges[0])
    rms = np.sqrt(np.mean(((hist - expected) / expected.max())**2))
    assert rms < 0.05
    # lifecycle flags cleared, done flag set
    lc = simulation.Lifecycle(folder)
    assert not lc.isRunning() and lc.isFinished()

  def test_end_after_hits(self, sceneAndFolder):
    scene, folder = sceneAndFolder
    scene.getObject('SimulationSettings').EndAfterRays = 'inf'
    scene.getObject('SimulationSettings').EndAfterHits = '7000'
    runPath = simulation.runSimulation(scene, 'true', seed=1)
    hits = loadAllHits(runPath, 'Source', 'Detector')
    assert hits is not None and len(hits['points']) >= 7000

  def test_single_pseudo(self, sceneAndFolder):
    scene, folder = sceneAndFolder
    runPath = simulation.runSimulation(scene, 'singlepseudo', seed=3)
    hits = loadAllHits(runPath, 'Source', 'Detector')
    # one iteration of 5000 rays
    assert hits is not None and 4000 < len(hits['points']) <= 5000

  def test_progress_files_written(self, sceneAndFolder):
    scene, folder = sceneAndFolder
    runPath = simulation.runSimulation(scene, 'true', seed=4)
    masters = glob.glob(os.path.join(runPath, 'progress', 'master-*'))
    assert masters
    with open(sorted(masters)[-1], 'rb') as f:
      prog = pickle.load(f)
    assert prog['totalTracedRays'] >= 2e4 and prog['reachedEnd']

  def test_stop_action_cancels(self, sceneAndFolder):
    scene, folder = sceneAndFolder
    simulation.runSimulation(scene, 'stop')
    lc = simulation.Lifecycle(folder)
    assert lc.isCanceled()
    lc.clearAll()


class TestFansE2E:

  def test_fan_mode_hits_and_metadata(self, sceneAndFolder):
    scene, folder = sceneAndFolder
    src = scene.getObject('Source')
    src.Fans = 2
    src.RaysPerFan = 21
    settings = scene.getObject('SimulationSettings')
    settings.StoreHitFanIndex = True
    settings.StoreHitRayIndex = True
    settings.StoreHitTotalFanCount = True
    settings.StoreHitTotalRaysInFan = True
    runPath = simulation.runSimulation(scene, 'fans')
    hits = loadAllHits(runPath, 'Source', 'Detector')
    assert hits is not None
    assert 'fanIndex' in hits and 'rayIndex' in hits
    fanIdx = hits['fanIndex'].astype(int)
    assert set(fanIdx) == {0, 1}
    # stitched mode (theta domain starts at 0): ray indices span +-
    rayIdx = hits['rayIndex'].astype(int)
    assert rayIdx.min() < 0 < rayIdx.max()
    # fans lie in planes: fan 0 at phi=0 -> hits along the y axis
    # (phi=0 -> direction (sin t sin 0, -sin t cos 0, cos t) = (0,-sin t, ..))
    pts0 = hits['points'][fanIdx == 0]
    assert np.abs(pts0[:, 0]).max() < 1e-3

  def test_ray_recording(self, sceneAndFolder):
    scene, folder = sceneAndFolder
    scene.getObject('Source').RecordRays = True
    runPath = simulation.runSimulation(scene, 'fans')
    from optics_design_workbench.simulation import results_store as RS
    rayFiles = RS.resultFilePaths(f'{runPath}/source-Source', 'rays')
    assert rayFiles
    data = RS.loadResultFile(rayFiles[0])
    offsets = data['offsets']
    nRays = len(offsets) - 1
    assert nRays >= 40   # 2 fans x 21 rays
    # each ray polyline: source origin -> detector
    p = data['points'][offsets[0]:offsets[1]]
    assert abs(p[0][2]) < 1e-3 and abs(p[-1][2] - 100.) < 1e-2


class TestMultiDeviceSharding:

  def test_trace_sharded_over_mesh(self, sceneAndFolder):
    import jax
    from jax.sharding import Mesh
    scene, folder = sceneAndFolder
    devices = np.array(jax.devices())
    mesh = Mesh(devices, ('rays',))
    runPath = simulation.runSimulation(scene, 'true', seed=5, mesh=mesh)
    hits = loadAllHits(runPath, 'Source', 'Detector')
    assert hits is not None and len(hits['points']) >= 19000


class TestHistogramFirstRecording:
  '''recording='histogram' keeps detector accumulation on device and only
  fetches a capped raw sample (VERDICT r1 #5: continuous stored runs must
  not pay the full raw-hit pipeline).'''

  def test_histogram_mode_stores_snapshots_and_samples(self, sceneAndFolder):
    from optics_design_workbench.simulation import results_store as RS
    scene, folder = sceneAndFolder
    runPath = simulation.runSimulation(
        scene, 'true', seed=7, recording='histogram',
        histBounds=(-50., 50., -50., 50.), histBins=(64, 64),
        rawSampleRays=512, rawSampleEvery=2)
    snaps = RS.loadHistogramSnapshots(runPath)
    assert 'Source' in snaps
    dets = snaps['Source']
    assert 'Detector' in dets
    h = dets['Detector']
    counts = h['counts']
    assert counts.shape == (64, 64)
    total = counts.sum()
    assert total > 1e4, 'histogram mode recorded almost no hits'
    # gaussian spot: the bin power concentrates near the center
    H, W = counts.shape
    inner = counts[H // 4: 3 * H // 4, W // 4: 3 * W // 4].sum()
    assert inner / total > .9
    assert np.allclose(h['bounds'], (-50., 50., -50., 50.))
    # capped raw samples were stored alongside
    raw = loadAllHits(runPath)
    assert raw is not None and 0 < len(raw['points']) < 5000
    # progress/end-criteria ran off the device counters
    masters = sorted(glob.glob(os.path.join(runPath, 'progress',
                                            'master-*')))
    with open(masters[-1], 'rb') as f:
      prog = pickle.load(f)
    assert prog['reachedEnd'] and prog['totalRecordedHits'] > 1e4

  def test_histogram_matches_raw_counts(self, sceneAndFolder):
    '''Same seed: the device histogram's total count equals the raw path's
    recorded hit count for a single-detector scene.'''
    from optics_design_workbench.simulation import results_store as RS
    scene, folder = sceneAndFolder
    runPath = simulation.runSimulation(
        scene, 'singletrue', seed=9, recording='histogram', store=True,
        histBounds=(-50., 50., -50., 50.), histBins=(64, 64),
        rawSampleRays=0)
    snaps = RS.loadHistogramSnapshots(runPath)
    nHist = snaps['Source']['Detector']['counts'].sum()
    runPath2 = simulation.runSimulation(scene, 'singletrue', seed=9,
                                        store=True)
    raw = loadAllHits(runPath2)
    # detector plane is 100x100 but the histogram window too: every raw
    # hit lands in-window
    assert nHist == len(raw['points'])
