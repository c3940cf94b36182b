'''
Surface source and replay source tests (reference: test/80-surface-source-
slow, replay_source.py semantics).
'''

import glob
import os

import numpy as np
import pytest

from optics_design_workbench.models import (Scene, PointSource,
                                            SurfaceSource, ReplaySource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation
from optics_design_workbench.simulation.lifecycle import SimulationEnded


def surfaceScene(tmp, kind='plane'):
  scene = Scene(label='surf', path=str(tmp / 'surf'))
  if kind == 'plane':
    emitSurfs = [S.plane(np.eye(4), elem=0, radius=5., orient=+1)]
  elif kind == 'sphere':
    emitSurfs = [S.sphere(np.eye(4), elem=0, radius=5.,
                          zRange=(3., 5.), orient=+1)]
  emitter = OpticalGroup(OpticalType='Vacuum', Label='Emitter',
                         RecordHits=False, surfaces=emitSurfs,
                         placements=[T.translation(0, 0, 0)])
  scene.addOpticalGroup(emitter)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(500., 500.))],
      placements=[T.translation(0, 0, 50)]))
  src = SurfaceSource(Label='SurfSource', ActiveSurfaces=['Emitter'],
                      PowerDensity='cos(theta)**2',
                      IgnoredOpticalElements=['Emitter'],
                      ThetaResolutionNumericMode='1e4')
  scene.addSource(src)
  scene.addSimulationSettings(EndAfterRays='5e3', RaysPerIteration=5000,
                              MaxIntersections=4,
                              EnableStoreSingleShotData=True)
  return scene


def loadHits(runPath, obj='Detector'):
  from optics_design_workbench.simulation import results_store as RS
  cols = None
  for folder in glob.glob(f'{runPath}/source-*/object-{obj}'):
    for f in RS.resultFilePaths(folder, 'hits'):
      data = RS.loadResultFile(f)
      if cols is None:
        cols = {k: [v] for k, v in data.items() if v.ndim > 0}
      else:
        for k in cols:
          cols[k].append(data[k])
  return None if cols is None else {k: np.concatenate(v)
                                    for k, v in cols.items()}


class TestSurfaceSource:

  def test_plane_emitter_mc(self, tmp_path):
    scene = surfaceScene(tmp_path, 'plane')
    runPath = simulation.runSimulation(scene, 'true', seed=7)
    hits = loadHits(runPath)
    assert hits is not None and len(hits['points']) >= 4900
    # emission from a disc of radius 5 at z=0 with cos^2 angular density:
    # lateral spread at z=50 dominated by angle; check the angular
    # distribution of initTheta metadata is cos^2-ish via hit radii
    r0 = np.hypot(hits['points'][:, 0], hits['points'][:, 1])
    assert np.quantile(r0, 0.5) < 60  # most hits within ~50*tan(45deg)

  def test_sphere_zone_emitter(self, tmp_path):
    scene = surfaceScene(tmp_path, 'sphere')
    runPath = simulation.runSimulation(scene, 'true', seed=8)
    hits = loadHits(runPath)
    assert hits is not None and len(hits['points']) > 3000

  def test_area_weighting(self, tmp_path):
    # two emitters with 1:4 area ratio -> ray counts ~1:4
    scene = Scene(label='two', path=str(tmp_path / 'two'))
    for label, r, x in (('Small', 2., -20.), ('Big', 4., 20.)):
      scene.addOpticalGroup(OpticalGroup(
          OpticalType='Vacuum', Label=label, RecordHits=False,
          surfaces=[S.plane(np.eye(4), elem=0, radius=r)],
          placements=[T.translation(x, 0, 0)]))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Detector',
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(500., 500.))],
        placements=[T.translation(0, 0, 5)]))
    src = SurfaceSource(Label='SS', ActiveSurfaces=['Small', 'Big'],
                        IgnoredOpticalElements=['Small', 'Big'],
                        ThetaDomain='0, 0.3',
                        ThetaResolutionNumericMode='1e4')
    scene.addSource(src)
    scene.addSimulationSettings(RaysPerIteration=4000,
                                EnableStoreSingleShotData=True)
    runPath = simulation.runSimulation(scene, 'singletrue', seed=9)
    hits = loadHits(runPath)
    assert hits is not None
    fromBig = np.sum(hits['points'][:, 0] > 0)
    fromSmall = np.sum(hits['points'][:, 0] <= 0)
    ratio = fromBig / max(fromSmall, 1)
    assert 3.0 < ratio < 5.5   # area ratio 16:4 = 4

  def test_fan_mode_grid(self, tmp_path):
    scene = surfaceScene(tmp_path, 'plane')
    scene.getObject('SurfSource').FanModeRayCount = 50
    runPath = simulation.runSimulation(scene, 'fans', store=True)
    hits = loadHits(runPath)
    assert hits is not None
    # rays launched along +z normal from the disc -> hit pattern reproduces
    # the grid positions
    assert np.allclose(hits['points'][:, 2], 50., atol=1e-3)
    r = np.hypot(hits['points'][:, 0], hits['points'][:, 1])
    assert r.max() < 5.01


class TestReplaySource:

  def test_replay_roundtrip(self, tmp_path):
    # run 1: point source onto detector, record hits
    scene = Scene(label='orig', path=str(tmp_path / 'orig'))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Vacuum', Label='Probe', RecordHits=True,
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
        placements=[T.translation(0, 0, 50)]))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Final', RecordHits=True,
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
        placements=[T.translation(0, 0, 100)]))
    scene.addSource(PointSource(Label='Src',
                                PowerDensity='exp(-theta^2/0.01)',
                                ThetaDomain='0, 0.3',
                                ThetaResolutionNumericMode='1e4'))
    scene.addSimulationSettings(RaysPerIteration=2000,
                                EnableStoreSingleShotData=True)
    run1 = simulation.runSimulation(scene, 'singletrue', seed=5)
    from optics_design_workbench.simulation import results_store as RS
    probeDir = os.path.join(run1, 'source-Src', 'object-Probe')
    assert RS.resultFilePaths(probeDir, 'hits')

    # run 2: replay the probe hits in a fresh scene
    scene2 = Scene(label='replayed', path=str(tmp_path / 'replayed'))
    scene2.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Detector',
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(300., 300.))],
        placements=[T.translation(0, 0, 100)]))
    replay = ReplaySource(Label='Replay', ReplayFromDir=probeDir,
                          usedFilesDir=str(tmp_path / 'used'))
    scene2.addSource(replay)
    scene2.addSimulationSettings(EnableStoreSingleShotData=True,
                                 EndAfterIterations='inf')
    run2 = simulation.runSimulation(scene2, 'true', seed=6)
    hits = loadHits(run2)
    assert hits is not None and len(hits['points']) > 1500
    # replayed rays start at z=50 moving +z: detector hits at z=100
    assert np.allclose(hits['points'][:, 2], 100., atol=1e-3)

    # stock exhausted: a second run ends via SimulationEnded with no hits
    run3 = simulation.runSimulation(scene2, 'true', seed=7)
    hits3 = loadHits(run3)
    assert hits3 is None

  def test_fans_unsupported(self, tmp_path):
    replay = ReplaySource(Label='R', ReplayFromDir=str(tmp_path),
                          usedFilesDir=str(tmp_path / 'used'))
    with pytest.raises(ValueError):
      replay.generateRays('fans')


def test_fit_piecewise_poly_accuracy():
  '''fitPiecewisePoly must reproduce tabulated inverse CDFs (with their
  sqrt-at-0 and thin-tail boundary layers) to < 5e-3 of the range, and
  give up (None) on a step it cannot fit.'''
  from optics_design_workbench.distributions.device_sampler import \
      fitPiecewisePoly as _fitPiecewisePoly
  q = np.linspace(0., 1., 4097)
  # gaussian-with-jacobian-like inverse: sqrt at 0, steep tail at 1
  inv = 0.35 * np.sqrt(-np.log1p(-q * (1 - np.exp(-6.))) / 6.)
  spec = _fitPiecewisePoly(inv)
  assert spec is not None and spec[0] == 'pwpoly'
  _, segs, lo, hi = spec
  qd = np.linspace(0., 1., 100001)
  ref = np.interp(qd, q, inv)
  est = np.zeros_like(qd)
  for a, b, mid, half, coeffs in segs:
    s = (qd - mid) / half
    acc = np.full_like(qd, coeffs[-1])
    for c in reversed(coeffs[:-1]):
      acc = acc * s + c
    est = np.where(qd >= a, acc, est)
  est = np.clip(est, lo, hi)
  assert np.abs(est - ref).max() < 5e-3 * np.ptp(inv)
  # a hard step cannot be fit by a few smooth segments
  step = np.where(q < .5, 0., 1.)
  assert _fitPiecewisePoly(step) is None


def test_old_pickle_gains_new_schema_defaults():
  '''A scene pickled before a property existed must unpickle with the
  schema default (PropertyMixin.__getattr__) instead of AttributeError —
  saved .scene.pkl files survive workbench upgrades, like FreeCAD re-adds
  missing properties on document load.'''
  import pickle
  from optics_design_workbench.models import PointSource
  s = PointSource(Label='x', PowerDensity='1')
  del s.__dict__['ViewColor']            # simulate the pre-upgrade pickle
  s2 = pickle.loads(pickle.dumps(s))
  assert s2.ViewColor == (1., 0., 0.)
  assert 'ViewColor' in s2.propertiesDict()
