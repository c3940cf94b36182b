'''Triangle-mesh ingestion: STL/OBJ loaders, OCC BRep stored-triangulation
extraction, and end-to-end tracing against a mesh element.'''

import struct
import zipfile

import numpy as np
import pytest

from optics_design_workbench.geometry import mesh as M
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T


def _quadVerts(z=0., half=10.):
  return np.array([[-half, -half, z], [half, -half, z],
                   [half, half, z], [-half, half, z]])


def _quadFaces():
  return np.array([[0, 1, 2], [0, 2, 3]])


def writeBinarySTL(path, verts, faces):
  with open(path, 'wb') as f:
    f.write(b'\0' * 80)
    f.write(struct.pack('<I', len(faces)))
    for tri in faces:
      f.write(struct.pack('<3f', 0., 0., 1.))
      for i in tri:
        f.write(struct.pack('<3f', *verts[i]))
      f.write(struct.pack('<H', 0))


def test_binary_stl_roundtrip(tmp_path):
  p = tmp_path / 'quad.stl'
  writeBinarySTL(p, _quadVerts(), _quadFaces())
  v, f = M.loadSTL(p)
  assert f.shape == (2, 3)
  got = np.sort(v[f].reshape(-1, 3), axis=0)
  want = np.sort(_quadVerts()[_quadFaces()].reshape(-1, 3), axis=0)
  np.testing.assert_allclose(got, want, atol=1e-6)


def test_ascii_stl(tmp_path):
  verts = _quadVerts()[_quadFaces()].reshape(-1, 3)
  lines = ['solid quad']
  for i in range(0, len(verts), 3):
    lines += ['facet normal 0 0 1', 'outer loop']
    lines += [f'vertex {x} {y} {z}' for x, y, z in verts[i:i + 3]]
    lines += ['endloop', 'endfacet']
  lines.append('endsolid quad')
  p = tmp_path / 'quad_ascii.stl'
  p.write_text('\n'.join(lines))
  v, f = M.loadSTL(p)
  assert f.shape == (2, 3)


def test_obj_loader_with_fan_triangulation(tmp_path):
  p = tmp_path / 'quad.obj'
  p.write_text('v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n'
               'f 1/1/1 2/2/2 3/3/3 4/4/4\n')
  v, f = M.loadOBJ(p)
  assert v.shape == (4, 3)
  assert f.shape == (2, 3)       # quad fan-triangulated


def test_mesh_surfaces_transform_and_validation():
  surfs = M.meshSurfaces(_quadVerts(), _quadFaces(), elem=0,
                         transform=T.translation(0, 0, 5.))
  assert len(surfs) == 2 and all(s['kind'] == S.TRIANGLE for s in surfs)
  assert np.allclose(surfs[0]['params'][2], 5.)   # z of v0 shifted
  with pytest.raises(ValueError):
    M.meshSurfaces(_quadVerts(), [[0, 1, 9]], elem=0)


BREP_V2 = '''DBRep_DrawableShape
Triangulations 1
4 2 1 0.01
-10 -10 0 10 -10 0 10 10 0 -10 10 0
0 0 1 0 1 1 0 1
1 2 3 1 3 4
'''

# OCC >= 7.6 variant: a normals flag follows the deflection
BREP_V3 = '''DBRep_DrawableShape
Triangulations 1
4 2 0 0.01 1
-10 -10 0 10 -10 0 10 10 0 -10 10 0
0 0 1 0 0 1 0 0 1 0 0 1
1 2 3 1 3 4
'''


@pytest.mark.parametrize('text', [BREP_V2, BREP_V3])
def test_brep_triangulation_variants(text):
  out = M.parseBRepTriangulations(text)
  assert len(out) == 1
  verts, tris = out[0]
  assert verts.shape == (4, 3) and tris.shape == (2, 3)
  assert tris.min() == 0 and tris.max() == 3


def test_brep_without_triangulation_raises():
  with pytest.raises(ValueError, match='no Triangulations'):
    M.parseBRepTriangulations('DBRep_DrawableShape\nTShapes 3\n')
  with pytest.raises(ValueError, match='0 triangulations'):
    M.parseBRepTriangulations('Triangulations 0\n')


def test_trace_against_mesh_detector(tmp_path):
  '''A mesh quad at z=50 must catch the same rays as an analytic plane.'''
  import glob
  from optics_design_workbench.models import (Scene, PointSource,
                                              OpticalGroup)
  from optics_design_workbench import simulation
  from optics_design_workbench.simulation import results_store as RS

  def run(useMesh):
    scene = Scene(label=f'meshdet{int(useMesh)}',
                  path=str(tmp_path / f'meshdet{int(useMesh)}'))
    if useMesh:
      surfs = M.meshSurfaces(_quadVerts(z=0., half=30.), _quadFaces(),
                             elem=0)
    else:
      surfs = [S.plane(np.eye(4), elem=0, halfExtents=(30., 30.))]
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Det', surfaces=surfs,
        placements=[T.translation(0, 0, 50)]))
    scene.addSource(PointSource(
        Label='Src', PowerDensity='1', ThetaDomain='0, 0.3',
        Wavelength=532., ThetaResolutionNumericMode='1e3'))
    scene.addSimulationSettings(RaysPerIteration=2000, MaxIntersections=2,
                                EndAfterIterations=1,
                                EnableStoreSingleShotData=True)
    runPath = simulation.runSimulation(scene, 'true', seed=11)
    pts = []
    for folder in glob.glob(f'{runPath}/source-*/object-Det'):
      for f in RS.resultFilePaths(folder, 'hits'):
        pts.append(RS.loadResultFile(f)['points'])
    return np.concatenate(pts)

  ptsMesh, ptsPlane = run(True), run(False)
  assert len(ptsMesh) == len(ptsPlane)    # same seed, same coverage
  np.testing.assert_allclose(ptsMesh[:, 2], 50., atol=1e-3)
  np.testing.assert_allclose(np.sort(ptsMesh[:, 0]),
                             np.sort(ptsPlane[:, 0]), atol=1e-3)


def test_fcstd_ingest_brep_mesh(tmp_path):
  '''A Part::Cut member with a stored BRep triangulation loads as a
  triangle mesh inside its optical group.'''
  docXml = '''<?xml version="1.0"?>
<Document SchemaVersion="4">
 <Objects Count="2">
  <Object name="Cut" type="Part::Cut"/>
  <Object name="OpticalAbsorberGroup" type="App::LinkGroupPython"/>
 </Objects>
 <ObjectData Count="2">
  <Object name="Cut">
   <Properties Count="2">
    <Property name="Shape" type="Part::PropertyPartShape">
     <Part file="CutShape.brp"/>
    </Property>
    <Property name="Label" type="App::PropertyString">
     <String value="CutSolid"/>
    </Property>
   </Properties>
  </Object>
  <Object name="OpticalAbsorberGroup">
   <Properties Count="3">
    <Property name="OpticalType" type="App::PropertyEnumeration">
     <CustomEnumList><Enum value="Mirror"/><Enum value="Absorber"/>
     </CustomEnumList>
     <Integer value="1"/>
    </Property>
    <Property name="ElementList" type="App::PropertyLinkList">
     <LinkList count="1"><Link value="Cut"/></LinkList>
    </Property>
    <Property name="Label" type="App::PropertyString">
     <String value="Det"/>
    </Property>
   </Properties>
  </Object>
 </ObjectData>
</Document>'''
  p = tmp_path / 'boolean.FCStd'
  with zipfile.ZipFile(p, 'w') as z:
    z.writestr('Document.xml', docXml)
    z.writestr('CutShape.brp', BREP_V2)
  from optics_design_workbench.models import fcstd_ingest
  scene = fcstd_ingest.loadFCStd(str(p), skipUnsupported=True)
  groups = scene.opticalObjects()
  assert len(groups) == 1
  tris = [s for s in groups[0].surfaces if s['kind'] == S.TRIANGLE]
  assert len(tris) == 2
