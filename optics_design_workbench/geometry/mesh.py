'''
Triangle-mesh ingestion: the catch-all geometry path for shapes that have
no analytic surface (CAD booleans, sketch-based solids, imported scans).

The reference delegates all such geometry to OpenCASCADE BReps and
intersects rays against them one OCC call at a time (ray.py:357-383);
here a mesh becomes a batch of TRIANGLE surfaces in the packed scene
table and rays intersect every triangle in the same vectorized per-kind
sweep as the analytic kinds (geometry/intersect.py). That is O(rays x
triangles) brute force, adequate for the few-hundred-triangle optical
elements this workbench targets; a broad phase for large CAD meshes is
future work.

Loaders: binary/ASCII STL, OBJ (triangulated on load), and best-effort
extraction of the stored triangulation from OpenCASCADE ASCII BRep blobs
(the `*.brp` payloads inside FCStd archives) so FreeCAD boolean/sketch
solids can load without an OCC kernel when FreeCAD saved them with
triangulation data.
'''

import struct

import numpy as np

from . import surfaces as S


def meshSurfaces(vertices, faces, elem, transform=None, orient=+1):
  '''Triangle-surface dicts for a (V, 3) x (F, 3) indexed mesh.

  transform: optional 4x4 applied to the vertices host-side (meshes bake
  their placement into the vertex coordinates — a per-triangle local
  frame would waste a packed transform per triangle).
  orient: +1 keeps each triangle's winding-order normal as "outward".'''
  vertices = np.asarray(vertices, dtype=float)
  faces = np.asarray(faces, dtype=int)
  if vertices.ndim != 2 or vertices.shape[1] != 3:
    raise ValueError(f'vertices must be (V, 3), got {vertices.shape}')
  if faces.ndim != 2 or faces.shape[1] != 3:
    raise ValueError(f'faces must be (F, 3), got {faces.shape}')
  if faces.size and (faces.min() < 0 or faces.max() >= len(vertices)):
    raise ValueError('face indices out of range')
  if transform is not None:
    m = np.asarray(transform, dtype=float)
    vertices = vertices @ m[:3, :3].T + m[:3, 3]
  tris = vertices[faces]          # (F, 3, 3)
  return [S.triangle(t[0], t[1], t[2], elem=elem, orient=orient)
          for t in tris]


# ---------------------------------------------------------------- STL ----

def loadSTL(path):
  '''(vertices, faces) from a binary or ASCII STL file. Vertices are NOT
  deduplicated (3 per triangle) — the tracer never needs shared vertices.'''
  with open(path, 'rb') as f:
    data = f.read()
  if data[:5].lower() == b'solid' and b'facet' in data[:1024]:
    return _parseAsciiSTL(data.decode('latin-1'))
  return _parseBinarySTL(data)


def _parseBinarySTL(data):
  if len(data) < 84:
    raise ValueError('not a binary STL: file shorter than its header')
  (n,) = struct.unpack_from('<I', data, 80)
  need = 84 + 50 * n
  if len(data) < need:
    raise ValueError(f'binary STL truncated: {n} triangles need {need} '
                     f'bytes, file has {len(data)}')
  raw = np.frombuffer(data, dtype=np.uint8, count=50 * n, offset=84)
  rec = raw.reshape(n, 50)[:, 12:48].copy()   # skip normal, drop attr
  verts = rec.view('<f4').reshape(n * 3, 3).astype(float)
  faces = np.arange(n * 3).reshape(n, 3)
  return verts, faces


def _parseAsciiSTL(text):
  verts = []
  for line in text.splitlines():
    parts = line.split()
    if len(parts) == 4 and parts[0] == 'vertex':
      verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
  if not verts or len(verts) % 3:
    raise ValueError(f'ASCII STL: vertex count {len(verts)} is not a '
                     f'multiple of 3')
  verts = np.asarray(verts)
  faces = np.arange(len(verts)).reshape(-1, 3)
  return verts, faces


# ---------------------------------------------------------------- OBJ ----

def loadOBJ(path):
  '''(vertices, faces) from a Wavefront OBJ; polygons are fan-triangulated.
  Only `v` and `f` records are used (normals/UVs/materials ignored).'''
  verts, faces = [], []
  with open(path) as f:
    for line in f:
      parts = line.split()
      if not parts:
        continue
      if parts[0] == 'v':
        verts.append([float(x) for x in parts[1:4]])
      elif parts[0] == 'f':
        idx = []
        for tok in parts[1:]:
          i = int(tok.split('/')[0])
          idx.append(i - 1 if i > 0 else len(verts) + i)
        for k in range(1, len(idx) - 1):
          faces.append([idx[0], idx[k], idx[k + 1]])
  if not faces:
    raise ValueError('OBJ file contains no faces')
  return np.asarray(verts, dtype=float), np.asarray(faces, dtype=int)


# ------------------------------------------------- OCC BRep (*.brp) ----

def parseBRepTriangulations(text):
  '''Best-effort extraction of the stored face triangulations from an
  OpenCASCADE ASCII BRep ("DBRep_DrawableShape"/"CASCADE Topology" format,
  the `PartShape.brp` payload inside FCStd archives).

  Returns a list of (vertices (N,3), faces (F,3)) — one per triangulated
  face. Raises ValueError when the blob stores no triangulation (FreeCAD
  only embeds it when the "save triangulation" preference is on or the
  shape was displayed before saving) or when the section cannot be
  decoded.

  Caveat (documented, not silent): node coordinates are taken as-is in
  the shape frame. Internal TopLoc locations on sub-shapes (nested
  compound placements inside one BRep) are NOT applied — single-solid
  results of booleans/pads (the overwhelmingly common case) carry the
  identity location and load exactly.'''
  marker = 'Triangulations'
  pos = text.find(marker)
  if pos < 0:
    raise ValueError(
        'BRep blob has no Triangulations section: FreeCAD saved this shape '
        'without its triangulation. Re-save with triangulation enabled, or '
        'export the element as STL/OBJ and load it with geometry.mesh.')
  toks = text[pos + len(marker):].split()
  it = iter(toks)

  def nxt():
    return next(it)

  try:
    count = int(nxt())
  except (StopIteration, ValueError) as e:
    raise ValueError(f'unreadable Triangulations header: {e}') from e
  if count == 0:
    raise ValueError(
        'BRep blob declares 0 triangulations: FreeCAD saved this shape '
        'without mesh data. Re-save with triangulation enabled, or export '
        'the element as STL/OBJ and load it with geometry.mesh.')
  out = []
  try:
    for _ in range(count):
      nNodes = int(nxt())
      nTris = int(nxt())
      hasUV = int(nxt())
      deflection = nxt()
      # OCC >= 7.6 ("locked" format version 3) inserts a normals flag
      # after the deflection; older writers go straight to coordinates.
      # Disambiguate by probing: a 0/1 integer token here that is NOT a
      # plausible coordinate start means a flags token.
      probe = nxt()
      hasNormals = 0
      if probe in ('0', '1'):
        hasNormals = int(probe)
        firstCoord = float(nxt())
      else:
        firstCoord = float(probe)
      coords = [firstCoord]
      coords.extend(float(nxt()) for _ in range(3 * nNodes - 1))
      verts = np.asarray(coords, dtype=float).reshape(nNodes, 3)
      if hasUV:
        for _ in range(2 * nNodes):
          nxt()
      if hasNormals:
        for _ in range(3 * nNodes):
          nxt()
      tris = np.asarray([int(nxt()) for _ in range(3 * nTris)],
                        dtype=int).reshape(nTris, 3) - 1   # 1-based
      if tris.size and (tris.min() < 0 or tris.max() >= nNodes):
        raise ValueError('triangle node index out of range')
      del deflection
      out.append((verts, tris))
  except (StopIteration, ValueError) as e:
    raise ValueError(
        f'failed to decode BRep triangulation section ({e}); this OCC '
        f'format variant is not understood — export the element as '
        f'STL/OBJ and load it with geometry.mesh instead') from e
  return out


def brepMeshSurfaces(text, elem, transform=None, orient=+1):
  '''Triangle surfaces for every stored face triangulation of a BRep
  blob (see parseBRepTriangulations for the caveats).'''
  surfs = []
  for verts, tris in parseBRepTriangulations(text):
    surfs.extend(meshSurfaces(verts, tris, elem=elem, transform=transform,
                              orient=orient))
  return surfs
