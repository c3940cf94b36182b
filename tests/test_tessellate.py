'''
Scene tessellation (geometry/tessellate.py): every analytic kind meshes,
vertices lie ON the exact surface, trim primitives and bitmaps cut the same
regions the tracer rejects, and the scene PLY writer produces a consistent
file (the headless analog of the reference's OCC-tessellated 3D view).
'''

import numpy as np
import pytest

from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.geometry.tessellate import (
                                                         tessellateSurface, tessellateScene, writeScenePLY)


def surfaceResidual(surf, verts):
  '''Exact implicit residual of world verts against the surface record.'''
  m = np.asarray(surf['transform'], dtype=float)
  local = (verts - m[:3, 3]) @ np.linalg.inv(m[:3, :3]).T
  p = np.asarray(surf['params'], dtype=float)
  kind = int(surf['kind'])
  x, y, z = local[:, 0], local[:, 1], local[:, 2]
  if kind == S.KIND_CODES['plane']:
    return np.abs(z)
  if kind == S.KIND_CODES['sphere']:
    return np.abs(np.sqrt(x * x + y * y + z * z) - p[0])
  if kind == S.KIND_CODES['cylinder']:
    return np.abs(np.sqrt(x * x + y * y) - p[0])
  if kind == S.KIND_CODES['cone']:
    return np.abs(np.sqrt(x * x + y * y) - (p[0] + z * p[1]))
  if kind == S.KIND_CODES['asphere']:
    r2 = x * x + y * y
    c, k = p[0], p[1]
    root = np.sqrt(np.maximum(1 - (1 + k) * c * c * r2, 1e-12))
    sag = c * r2 / (1 + root) + r2 * r2 * (p[2] + r2 * (p[3] + r2 * p[4]))
    return np.abs(z - sag)
  if kind == S.KIND_CODES['quadric']:
    return np.abs(p[0] * x * x + p[1] * y * y + p[2] * z * z
                  + p[3] * z + p[4])
  raise AssertionError(kind)


KINDS = [
    S.plane(T.translation(1, 2, 3), 0, radius=30.),
    S.plane(np.eye(4), 0, halfExtents=(20., 10.)),
    S.sphere(T.rotation((1, 0, 0), 30.), 0, 25., zRange=(10., 25.)),
    S.cylinder(np.eye(4), 0, 10., (0., 40.)),
    S.cone(np.eye(4), 0, 5., 0.5, (0., 30.)),
    S.asphere(np.eye(4), 0, 1 / 50., conic=-1., rMax=20.),
    S.quadric(np.eye(4), 0, (1e-2, 1e-2, 2.5e-3, 0., -1.), (-15., 15.)),
]


class TestKinds:

  @pytest.mark.parametrize('surf', KINDS,
                           ids=[S._KIND_NAMES[s['kind']] + str(i)
                                for i, s in enumerate(KINDS)])
  def test_verts_on_surface(self, surf):
    verts, tris = tessellateSurface(surf, resolution=24)
    assert len(tris) > 100
    assert tris.min() >= 0 and tris.max() < len(verts)
    assert surfaceResidual(surf, verts).max() < 1e-9

  def test_triangle_kind_passthrough(self):
    verts, tris = tessellateSurface(
        S.triangle((0, 0, 0), (10, 0, 0), (0, 10, 0), 0))
    np.testing.assert_allclose(verts[1], (10., 0., 0.))
    assert tris.tolist() == [[0, 1, 2]]

  def test_infinite_plane_capped(self):
    verts, _ = tessellateSurface(S.plane(np.eye(4), 0), resolution=8,
                                 infiniteExtent=77.)
    r = np.sqrt((verts[:, :2] ** 2).sum(axis=1))
    np.testing.assert_allclose(r.max(), 77.)

  def test_sphere_band_respected(self):
    verts, _ = tessellateSurface(KINDS[2], resolution=16)
    m = np.asarray(KINDS[2]['transform'])
    local = (verts - m[:3, 3]) @ np.linalg.inv(m[:3, :3]).T
    assert local[:, 2].min() >= 10. - 1e-9
    assert local[:, 2].max() <= 25. + 1e-9


class TestTrims:

  def test_prim_hole_cut(self):
    surf = S.plane(np.eye(4), 0, radius=30.)
    surf['trim'] = np.array([3., 0., 30., 0., 0., 0.])
    surf['trimPrims'] = dict(holes=[(1., 0., 0., 10., 10., 1., 0.)])
    verts, tris = tessellateSurface(surf, resolution=64)
    cent = verts[tris].mean(axis=1)
    assert len(tris) > 1000
    # no triangle centroid inside the 10x10 rect hole (shrunk margin for
    # boundary cells)
    assert not ((np.abs(cent[:, 0]) < 8.) & (np.abs(cent[:, 1]) < 8.)).any()

  def test_bitmap_cut(self):
    surf = S.plane(np.eye(4), 0, halfExtents=(10., 10.))
    mask = np.ones((32, 32), dtype=np.uint8)
    mask[16:, :] = 0      # v-major bitmap (surfaces._maskLookup is
    # mask[iv, iu]): zeroing the upper rows cuts the v = y >= 0 half away
    surf['trimBitmap'] = dict(mask=mask, u0=-10., v0=-10.,
                              invDu=32 / 20., invDv=32 / 20.)
    verts, tris = tessellateSurface(surf, resolution=48)
    cent = verts[tris].mean(axis=1)
    assert len(tris) > 300
    assert cent[:, 1].max() < 1.     # only the y<0 half survives


class TestSceneExport:

  def makeScene(self, tmp_path):
    from optics_design_workbench.models import (Scene, PointSource,
                                                OpticalGroup)
    scene = Scene(label='tess', path=str(tmp_path / 'tess'))
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Mirror', Label='M', ViewColor=(0., 1., 0.),
        surfaces=[S.sphere(np.eye(4), 0, 100., zRange=(95., 100.))],
        placements=[T.translation(0, 0, -60), T.translation(0, 0, 60)]))
    scene.addSource(PointSource(Label='Src', PowerDensity='1',
                                ThetaDomain='0, pi/8'))
    scene.addSimulationSettings(RaysPerIteration=8, MaxIntersections=3,
                                MaxRayLength=500)
    return scene

  def test_tessellate_scene_instances(self, tmp_path):
    scene = self.makeScene(tmp_path)
    pieces = tessellateScene(scene, resolution=12)
    assert len(pieces) == 2                 # one per placement
    labels = {p[0] for p in pieces}
    assert labels == {'M'}
    # the two instances are offset by the placements
    z0 = pieces[0][2][:, 2].mean()
    z1 = pieces[1][2][:, 2].mean()
    assert abs(abs(z0 - z1) - 120.) < 5.

  def test_write_scene_ply_with_rays(self, tmp_path):
    scene = self.makeScene(tmp_path)
    from optics_design_workbench import simulation
    from optics_design_workbench.simulation.draw import DrawnRays
    drawn = DrawnRays()
    simulation.runSimulation(scene, 'singletrue', draw=drawn, seed=1,
                             store=False)
    path = writeScenePLY(scene, str(tmp_path / 'scene.ply'), resolution=12,
                         drawnRays=drawn)
    lines = open(path).read().splitlines()
    nV = int(next(l for l in lines if l.startswith('element vertex'))
             .split()[-1])
    nF = int(next(l for l in lines if l.startswith('element face'))
             .split()[-1])
    nE = int(next(l for l in lines if l.startswith('element edge'))
             .split()[-1])
    assert nE == drawn.segmentCount and nF > 0
    body = lines[lines.index('end_header') + 1:]
    assert len(body) == nV + nF + nE
    # face and edge indices reference valid vertices
    f = np.array([list(map(int, l.split()))[1:] for l in body[nV:nV + nF]])
    e = np.array([list(map(int, l.split())) for l in body[nV + nF:]])
    assert f.max() < nV and e.max() < nV and f.min() >= 0 and e.min() >= 0
    # scene vertices carry the group's green; ray vertices the source red
    v0 = body[0].split()
    assert v0[3:] == ['0', '255', '0']
    assert body[nV - 1].split()[3:] == ['255', '0', '0']


class TestAddPrimTabs:

  def test_add_tab_outside_base_is_meshed(self):
    '''Boolean-ADD prims protruding past the base window (the tabs
    brep._fitTrimPrims emits for boolean unions) must be covered by the
    grid: rays hit them, so the mesh must show them.'''
    surf = S.plane(np.eye(4), 0, halfExtents=(10., 10.))
    surf['trim'] = np.array([4., 10., 10., 0., 0., 0.])
    # ADD disc of radius 5 centered at x=14 (sticks out to x=19)
    surf['trimPrims'] = dict(holes=[(12., 14., 0., 25., 0., 1., 0.)])
    verts, tris = tessellateSurface(surf, resolution=64)
    cent = verts[tris].mean(axis=1)
    assert cent[:, 0].max() > 15.          # tab area present
    # but nothing occupied between base edge and tab except the disc
    outside = cent[(cent[:, 0] > 10.5)]
    assert ((outside[:, 0] - 14.) ** 2 + outside[:, 1] ** 2 < 26.).all()

  def test_bitmap_boundary_ring_kept(self):
    '''Fencepost regression: a fully-occupied bitmap window tessellates to
    the FULL window extent (the far-edge vertex row used to be dropped).'''
    surf = S.plane(np.eye(4), 0, halfExtents=(10., 10.))
    surf['trimBitmap'] = dict(mask=np.ones((16, 16), np.uint8),
                              u0=-10., v0=-10.,
                              invDu=16 / 20., invDv=16 / 20.)
    verts, tris = tessellateSurface(surf, resolution=16)
    used = verts[np.unique(tris)]
    np.testing.assert_allclose(used[:, 0].max(), 10., atol=1e-9)
    np.testing.assert_allclose(used[:, 1].max(), 10., atol=1e-9)

  def test_bitmap_band_kind_uses_window(self):
    '''Bitmap-trimmed CURVED faces grid over the trimBitmap window, not
    the zeroed trim row (regression: a bitmap cylinder collapsed to a
    zero-extent sliver at z=0).'''
    surf = S.cylinder(np.eye(4), 0, 10., (0., 0.))   # trim row zeroed-ish
    surf['trim'] = np.array([2., 0., 0., 0., 0., 0.])
    mask = np.ones((16, 16), dtype=np.uint8)
    surf['trimBitmap'] = dict(mask=mask, u0=-np.pi, v0=-5.,
                              invDu=16 / (2 * np.pi), invDv=16 / 10.)
    verts, tris = tessellateSurface(surf, resolution=16)
    assert len(tris) > 100
    assert verts[:, 2].min() < -4.9 and verts[:, 2].max() > 4.9
    r = np.sqrt(verts[:, 0] ** 2 + verts[:, 1] ** 2)
    np.testing.assert_allclose(r, 10., atol=1e-9)
