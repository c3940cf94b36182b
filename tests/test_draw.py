'''
Headless ray drawing (simulation/draw.py) — the stand-in for the reference
GUI's drawn ray objects (generic_source.py:86-140): polyline collection,
reference color-blend semantics (ray.py:136-142), PLY/OBJ export, npz
round-trip and the runner's draw=True wiring.
'''

import os

import numpy as np
import pytest

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation
from optics_design_workbench.simulation.draw import (DrawnRays,
                                                     sceneDrawParams)


@pytest.fixture
def scene(tmp_path):
  scene = Scene(label='drawscene', path=str(tmp_path / 'drawscene'))
  # pass-through vacuum detector that re-colors rays crossing it ...
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Vacuum', Label='Window',
      ViewColor=(0., 0., 1.), ViewColorWeight=0.5,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.translation(0, 0, 50)]))
  # ... then an absorbing screen
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Screen',
      surfaces=[S.plane(np.eye(4), elem=1, halfExtents=(50., 50.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(PointSource(
      Label='Source', PowerDensity='1', ThetaDomain='0, pi/16',
      Wavelength=532., ViewColor=(1., 0., 0.)))
  scene.addSimulationSettings(
      RaysPerIteration=64, MaxIntersections=4, MaxRayLength=1000,
      EnableStoreSingleShotData=True)
  return scene


def runDrawn(scene, action='singletrue'):
  drawn = DrawnRays()
  runPath = simulation.runSimulation(scene, action, draw=drawn, seed=7)
  return drawn, runPath


class TestDrawCollection:

  def test_polylines_and_blend(self, scene):
    drawn, _ = runDrawn(scene)
    assert drawn.rayCount == 64
    # every ray: source -> window -> screen = 2 segments, 3 points
    for i in range(drawn.rayCount):
      pts, colors, powers = drawn.polyline(i)
      assert len(pts) == 3 and len(colors) == 2 and len(powers) == 2
      # polyline continuity and direction (rays travel towards +z)
      assert pts[0][2] < pts[1][2] < pts[2][2]
      np.testing.assert_allclose(pts[1][2], 50., atol=1e-3)
      np.testing.assert_allclose(pts[2][2], 100., atol=1e-3)
      # segment 1 carries the source color; segment 2 the 0.5-blend with
      # the window's blue (reference rule color=(1-w)*c+w*new,
      # generic_source.py:116-119)
      np.testing.assert_allclose(colors[0], (1., 0., 0.), atol=1e-12)
      np.testing.assert_allclose(colors[1], (.5, 0., .5), atol=1e-12)

  def test_segments_view_matches_polylines(self, scene):
    drawn, _ = runDrawn(scene)
    segs, colors, powers = drawn.segments()
    assert segs.shape == (drawn.segmentCount, 2, 3)
    assert len(colors) == len(powers) == drawn.segmentCount
    p0, c0, w0 = drawn.polyline(0)
    np.testing.assert_allclose(segs[0, 0], p0[0])
    np.testing.assert_allclose(segs[0, 1], p0[1])
    np.testing.assert_allclose(colors[0], c0[0])

  def test_scene_draw_params_order(self, scene):
    params = sceneDrawParams(scene)
    np.testing.assert_allclose(params['elementColors'][0], (0., 0., 1.))
    assert params['elementWeights'][0] == 0.5
    assert params['elementWeights'][1] == 0.

  def test_continuous_action_ignores_draw(self, scene):
    scene.addSimulationSettings(EndAfterIterations='1', RaysPerIteration=16,
                                MaxIntersections=4, MaxRayLength=1000)
    drawn = DrawnRays()
    simulation.runSimulation(scene, 'true', draw=drawn, seed=3)
    assert drawn.rayCount == 0


class TestDrawExports:

  def test_run_folder_artifacts_and_ply(self, scene):
    drawn, runPath = runDrawn(scene)
    ply = os.path.join(runPath, 'drawn-rays.ply')
    assert os.path.exists(ply)
    lines = open(ply).read().splitlines()
    assert lines[0] == 'ply'
    nV = int(next(l for l in lines if l.startswith('element vertex'))
             .split()[-1])
    nE = int(next(l for l in lines if l.startswith('element edge'))
             .split()[-1])
    assert nV == len(drawn.points) and nE == drawn.segmentCount
    body = lines[lines.index('end_header') + 1:]
    assert len(body) == nV + nE
    # first vertex: 3 floats + uchar color of the first (red) segment
    v0 = body[0].split()
    assert len(v0) == 6 and v0[3:] == ['255', '0', '0']
    # edges reference valid vertices
    e = np.array([list(map(int, l.split())) for l in body[nV:]])
    assert e.min() >= 0 and e.max() < nV

  def test_obj_export(self, scene, tmp_path):
    drawn, _ = runDrawn(scene)
    path = drawn.writeOBJ(str(tmp_path / 'rays.obj'))
    lines = open(path).read().splitlines()
    nV = sum(1 for l in lines if l.startswith('v '))
    nL = sum(1 for l in lines if l.startswith('l '))
    assert nV == len(drawn.points) and nL == drawn.rayCount

  def test_npz_roundtrip(self, scene, tmp_path):
    drawn, _ = runDrawn(scene)
    drawn.save(str(tmp_path / 'out'))
    back = DrawnRays.load(str(tmp_path / 'out'))
    np.testing.assert_allclose(back.points, drawn.points)
    np.testing.assert_allclose(back.colors, drawn.colors)
    np.testing.assert_array_equal(back.offsets, drawn.offsets)
    assert back.sourceLabels == drawn.sourceLabels

  def test_clear(self, scene):
    drawn, _ = runDrawn(scene)
    assert drawn.clear().rayCount == 0 and len(drawn.points) == 0


class TestDrawPlot:

  def test_plot_3d_and_2d(self, scene):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    drawn, _ = runDrawn(scene)
    ax = drawn.plot()
    assert ax.name == '3d'
    plt.close('all')
    ax2 = drawn.plot(plane='xz', maxRays=16)
    assert ax2.name != '3d'
    plt.close('all')


class TestFromStoredRays:

  def test_from_rays_and_scene_plot(self, scene, tmp_path):
    '''RecordRays run -> loadRays -> DrawnRays.fromRays -> plotScene: the
    stored-polyline visualization path (reference users inspect stored
    rays in the FreeCAD view; here via matplotlib / PLY).'''
    from optics_design_workbench.jupyter_utils import (DrawnRays as DR,
                                                       plotScene,
                                                       rawFolders)
    for src in scene.lightSources():
      src.RecordRays = True
    runPath = simulation.runSimulation(scene, 'singletrue', seed=2)
    from optics_design_workbench.jupyter_utils.document import RawFolder
    rays = RawFolder(runPath).loadRays()
    assert len(rays) == 64
    drawn = DR.fromRays(rays, sourceColor=(0., 1., 0.))
    assert drawn.rayCount == 64
    assert drawn.segmentCount == sum(len(r['powers']) for r in rays)
    segs, colors, powers = drawn.segments()
    assert len(segs) == drawn.segmentCount
    np.testing.assert_allclose(colors[0], (0., 1., 0.))
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    ax = plotScene(scene, drawnRays=drawn, resolution=8)
    assert ax.name == '3d'
    plt.close('all')
