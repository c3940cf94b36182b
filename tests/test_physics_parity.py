'''
Physics-validation tests, the analog of the reference's CI-enforced
quantitative notebooks (reference: test/70-point-source-slow — fan mode
reconstructed power density vs the analytic expression, Monte-Carlo
histograms vs expectation; test/22-global-placement — exact placements
through containers and multi-placement Links).
'''

import glob

import numpy as np
import pytest
import sympy as sy

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation
from optics_design_workbench.jupyter_utils import RawFolder


def detectorScene(tmp, detDistance=100., **sourceKwargs):
  scene = Scene(label='phys', path=str(tmp / 'phys'))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(500., 500.))],
      placements=[T.translation(0, 0, detDistance)]))
  scene.addSource(PointSource(Label='Src', **sourceKwargs))
  scene.addSimulationSettings(
      RaysPerIteration=20000, EnableStoreSingleShotData=True,
      MaxIntersections=3,
      StoreHitFanIndex=True, StoreHitRayIndex=True,
      StoreHitTotalFanCount=True, StoreHitTotalRaysInFan=True,
      StoreHitInitTheta=True, StoreHitInitPhi=True)
  return scene


class TestFanModePhysicsParity:
  '''Per-fan reconstructed power density (1/neighbor spacing vs signed
  center distance) must match the analytic expression (reference threshold:
  median RMS < 1e-2, max < 0.1 over distributions x domains —
  0-test-fan-mode.ipynb). We check a representative subset.'''

  @pytest.mark.parametrize('expr,domain', [
      ('exp(-theta^2/0.01)', '0, 0.3'),
      ('exp(-theta^2/0.003)', '0, 0.2'),
      ('1 + 0*theta', '0, 0.25'),
      ('cos(theta)**2', '0, 0.4'),
  ])
  def test_fan_density_matches_expression(self, tmp_path, expr, domain):
    D = 100.
    scene = detectorScene(tmp_path, detDistance=D, PowerDensity=expr,
                          ThetaDomain=domain,
                          ThetaResolutionNumericMode='2e4',
                          Fans=1, RaysPerFan=201)
    runPath = simulation.runSimulation(scene, 'fans', store=True)
    hits = RawFolder(runPath).loadHits('Detector')
    assert hits.supportsFanMath()
    dens = hits.fanEstimatedPowerDensities()
    assert 0 in dens
    pos, est = dens[0]
    # expected density vs signed distance r = D*tan(theta):
    # fan linear density ~ pdf(theta) * dtheta/dr
    lam = sy.lambdify('theta', sy.sympify(expr.replace('^', '**')))
    theta = np.arctan(np.abs(pos) / D)
    expected = lam(theta) / (D / np.cos(theta) ** 2)
    expected = np.broadcast_to(expected, est.shape)
    # normalize both to unit mean and compare
    estN = est / est.mean()
    expN = expected / expected.mean()
    rms = np.sqrt(np.mean(((estN - expN) / expN.max()) ** 2))
    assert rms < 0.05, f'{expr}: fan density RMS {rms:.3f}'

  def test_collimated_fan(self, tmp_path):
    scene = detectorScene(tmp_path, PowerDensity='exp(-r^2/4)',
                          FocalLength='inf', RadiusDomain='0, 5',
                          RadiusResolutionNumericMode='2e4',
                          Fans=1, RaysPerFan=101)
    runPath = simulation.runSimulation(scene, 'fans', store=True)
    hits = RawFolder(runPath).loadHits('Detector')
    pos, est = hits.fanEstimatedPowerDensities()[0]
    expected = np.exp(-pos ** 2 / 4)
    estN, expN = est / est.mean(), expected / expected.mean()
    rms = np.sqrt(np.mean(((estN - expN) / expN.max()) ** 2))
    assert rms < 0.05


class TestMonteCarloPhysicsParity:
  '''Monte-Carlo hit histograms vs expectation (reference threshold:
  median RMS < 0.3, max < 3 at 1e5 hits — 1-test-monte-carlo.ipynb).'''

  def test_astigmatic_gaussian(self, tmp_path):
    # the reference's astigmatic beam case (2-test-astigmatic-beams.ipynb)
    expr = 'exp(-2*((theta*cos(phi))^2/0.01^2 + (theta*sin(phi))^2/0.1^2))'
    scene = detectorScene(tmp_path, PowerDensity=expr,
                          ThetaDomain='0, 0.35',
                          ThetaResolutionNumericMode='4e3',
                          PhiResolutionNumericMode='181')
    scene.getObject('SimulationSettings').EndAfterRays = '1e5'
    scene.getObject('SimulationSettings').RaysPerIteration = 50000
    runPath = simulation.runSimulation(scene, 'true', seed=10)
    hits = RawFolder(runPath).loadHits('Detector')
    pts = hits.points()
    assert len(pts) >= 1e5
    # direction convention d = (sin t sin phi, -sin t cos phi, cos t):
    # the wide lobe (theta*sin(phi), sigma 0.1) lands on the x axis
    assert pts[:, 0].std() > 5 * pts[:, 1].std()
    sigmaX = np.arctan(pts[:, 0].std() / 100.)
    assert abs(sigmaX - 0.1 / 2) < 0.01   # exp(-2 t^2/s^2): std = s/2

  def test_phi_clipped_source(self, tmp_path):
    scene = detectorScene(tmp_path, PowerDensity='exp(-theta^2/0.01)',
                          ThetaDomain='0.05, 0.3', PhiDomain='0, pi/2',
                          ThetaResolutionNumericMode='4e3')
    runPath = simulation.runSimulation(scene, 'singletrue', seed=11)
    hits = RawFolder(runPath).loadHits('Detector')
    pts = hits.points()
    # direction (sin t sin phi, -sin t cos phi, cos t), phi in (0, pi/2):
    # x >= 0 and y <= 0 quadrant only
    assert (pts[:, 0] >= -1e-3).all() and (pts[:, 1] <= 1e-3).all()
    # annular theta domain: no hits near the axis
    r = np.hypot(pts[:, 0], pts[:, 1])
    assert r.min() > 100 * np.tan(0.05) - 0.5


class TestGlobalPlacements:
  '''Multi-placement instancing: one optical group realized at several
  global transforms (reference: common.py:36-109; asserted matrices in
  test/22-global-placement).'''

  def test_multi_placement_group(self, tmp_path):
    scene = Scene(label='multi', path=str(tmp_path / 'multi'))
    # ONE detector group instanced at three placements
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Det',
        surfaces=[S.plane(np.eye(4), elem=0, radius=3.)],
        placements=[
            T.translation(0, 0, 50),
            T.compose(T.translation(30, 0, 50), T.rotation((0, 1, 0), 0)),
            T.compose(T.translation(-30, 0, 50), T.rotation((1, 0, 0), 10)),
        ]))
    scene.addSource(PointSource(Label='S', PowerDensity='1',
                                ThetaDomain='0, 0.7',
                                ThetaResolutionNumericMode='4e3'))
    scene.addSimulationSettings(RaysPerIteration=40000,
                                EnableStoreSingleShotData=True,
                                MaxIntersections=2)
    runPath = simulation.runSimulation(scene, 'singletrue', seed=12)
    hits = RawFolder(runPath).loadHits('Det')
    pts = hits.points()
    # all three instances collect hits
    near = lambda x0: np.sum(np.hypot(pts[:, 0] - x0, pts[:, 1]) < 4)
    assert near(0) > 100 and near(30) > 100 and near(-30) > 50
    # the tilted instance's hits lie on its tilted plane, not z=50
    sel = np.abs(pts[:, 0] + 30) < 3
    zSpread = np.ptp(pts[sel][:, 2])
    assert zSpread > 0.3   # tan(10deg)*2*3 ~ 1.06 across the disc

  def test_nested_container_transform(self, tmp_path):
    # compose placements like nested App::Part containers: the surface
    # spec transform composes with the group placement exactly
    inner = T.compose(T.translation(5, 0, 0), T.rotation((0, 0, 1), 90))
    outer = T.compose(T.translation(0, 0, 80), T.rotation((0, 1, 0), 180))
    scene = Scene(label='nest', path=str(tmp_path / 'nest'))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='D',
        surfaces=[S.plane(inner, elem=0, halfExtents=(4., 2.))],
        placements=[outer]))
    # source 40mm above the detector center (-5, 0, 80), aimed straight
    # down: the 0.4 rad cone covers the 4x2 plate with margin
    scene.addSource(PointSource(Label='S', PowerDensity='1',
                                ThetaDomain='0, 0.4', FanPhi0='0',
                                ThetaResolutionNumericMode='4e3',
                                placement=T.compose(
                                    T.translation(-5, 0, 120),
                                    T.rotation((1, 0, 0), 180))))
    scene.addSimulationSettings(RaysPerIteration=20000,
                                EnableStoreSingleShotData=True,
                                MaxIntersections=2)
    # expected detector plane: outer @ inner applied to z=0 plane ->
    # rotated 180 about y: located at (-5, 0, 80), extents swapped by the
    # 90deg z-rotation (halfExtents 4 along local x -> global y)
    expect = T.compose(outer, inner)
    center = T.applyToPoints(expect, np.zeros((1, 3)))[0]
    assert np.allclose(center, [-5, 0, 80], atol=1e-9)
    runPath = simulation.runSimulation(scene, 'singletrue', seed=13)
    hits = RawFolder(runPath).loadHits('D')
    assert len(hits) > 500, 'aimed source must hit the nested detector'
    pts = hits.points()
    assert np.allclose(pts[:, 2], 80., atol=1e-3)
    assert np.abs(pts[:, 0] + 5).max() < 2.01 + 1e-3   # global x extent = 2
    assert np.abs(pts[:, 1]).max() < 4.01 + 1e-3       # global y extent = 4
