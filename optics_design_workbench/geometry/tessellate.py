'''
Scene tessellation for headless viewing — meshes the exact analytic surface
records back into triangles so a scene can be inspected in any standard 3D
viewer next to its drawn rays (simulation/draw.py).

The reference gets its 3D view for free: FreeCAD/OCC tessellates the
Part::Feature shapes the workbench operates on (reference: ray.py:303-311
lists the obj.Shape/BoundBox accessors; the GUI draws those shapes). Here
the scene IS the analytic table (geometry/surfaces.py), so this module is
the inverse of brep.py's ingest: parametric grids per surface kind, trimmed
by the same ring/rect/band windows, boolean-cut trim primitives
(surfaces._applyPrims) and UV occupancy bitmaps the tracer applies — a
vertex is kept exactly when a ray could hit there.

Writers: `writeScenePLY(scene, path, drawnRays=...)` emits one PLY with
per-element colored faces (ViewColor) plus, optionally, the colored ray
edges of a DrawnRays — scene and rays in a single MeshLab/Blender-ready
file.
'''

import numpy as np

from . import surfaces as S
from ..utils import io


# --------------------------------------------------- numpy trim evaluation

def _applyPrimsNp(prims, x, y, z, baseOk):
  '''Numpy twin of surfaces._applyPrims (same row layout; see there).'''
  addHit = np.zeros_like(baseOk)
  holeHit = np.zeros_like(baseOk)
  for row in np.asarray(prims, dtype=float):
    flag = row[0]
    if flag <= 0.5:
      continue
    isInv = flag > 15.5
    rem = flag - (20. if isInv else 0.)
    isAdd = rem > 5.5
    shape = rem - (10. if isAdd else 0.)
    dxp, dyp = x - row[1], y - row[2]
    xr = row[5] * dxp + row[6] * dyp
    yr = -row[6] * dxp + row[5] * dyp
    if shape > 5.5:
      inP = x * row[1] + y * row[2] + z * row[3] >= row[4]
    elif shape > 4.5:
      inP = (row[1] * x * x + row[2] * x * y + row[3] * y * y
             + row[4] * x + row[5] * y + row[6]) <= 0.
    elif shape > 3.5:
      inP = yr <= row[3] * xr * xr + row[4] * xr
    elif shape > 2.5:
      inP = dxp * row[3] + dyp * row[4] >= 0
    elif shape > 1.5:
      inP = dxp * dxp + dyp * dyp <= row[3]
    else:
      inP = (np.abs(xr) <= row[3]) & (np.abs(yr) <= row[4])
    inP = inP != isInv
    if isAdd:
      addHit |= inP
    else:
      holeHit |= inP
  return (baseOk | addHit) & ~holeHit


def _bitmapOkNp(bm, u, v, tolerancePx=0.):
  '''Numpy twin of surfaces._maskLookup over a trimBitmap record.
  tolerancePx widens the WINDOW border test by that many pixels (used by
  the tessellation occupancy test with 0.5: grid vertices landing exactly
  on the window's far edge — fu == R — are the limit of occupied cells and
  must not drop the whole boundary cell ring; interior mask edges are
  unaffected).'''
  mask = np.asarray(bm['mask'])
  R = mask.shape[0]
  fu = (u - bm['u0']) * bm['invDu']
  fv = (v - bm['v0']) * bm['invDv']
  iu = np.clip(np.floor(fu).astype(int), 0, R - 1)
  iv = np.clip(np.floor(fv).astype(int), 0, R - 1)
  t = tolerancePx
  return ((fu >= -t) & (fu < R + t) & (fv >= -t) & (fv < R + t)
          & (mask[iv, iu] > 0))


def _vertexOk(surf, pts, u, v, baseOk=None):
  '''Occupancy of local points `pts` (..., 3) with band/window coordinate
  (u, v) under the surface's trims — the tessellation-side mirror of
  surfaces._trimPlane/_trimBandOk. baseOk is the base-window test; it
  defaults to all-True because most grids span exactly the base window,
  but grids EXTENDED past it (boolean-ADD tabs) must pass the real one.'''
  ok = (np.ones(pts.shape[:-1], dtype=bool) if baseOk is None
        else np.asarray(baseOk))
  if 'trimBitmap' in surf:
    ok = ok & _bitmapOkNp(surf['trimBitmap'], u, v, tolerancePx=0.5)
  if 'trimPrims' in surf:
    ok = _applyPrimsNp(surf['trimPrims']['holes'],
                       pts[..., 0], pts[..., 1], pts[..., 2], ok)
  return ok


def _addPrimBounds(surf):
  '''Local-(x, y) bbox of bounded boolean-ADD trim primitives (rects and
  discs; brep._fitTrimPrims emits these for tabs protruding beyond the
  fitted base window), or None. The tessellation grid must cover them or
  the exported mesh silently misses face area the tracer can hit.'''
  if 'trimPrims' not in surf:
    return None
  lo = np.array([np.inf, np.inf])
  hi = -lo
  found = False
  for row in np.asarray(surf['trimPrims']['holes'], dtype=float):
    flag = row[0]
    if flag <= 0.5 or flag > 15.5:   # inactive, or inverted (complement =
      continue                       # unbounded — cannot extend a mesh)
    rem = flag - 10.
    if rem <= 0.5:                   # not an ADD prim
      continue
    cx, cy = row[1], row[2]
    if rem < 1.5:                    # rotated rect: half-extents p0, p1
      ex = abs(row[5] * row[3]) + abs(row[6] * row[4])
      ey = abs(row[6] * row[3]) + abs(row[5] * row[4])
    elif rem < 2.5:                  # disc: radius^2 in p0
      ex = ey = np.sqrt(max(row[3], 0.))
    else:
      continue                       # half-plane/poly2/conic: unbounded
    lo = np.minimum(lo, (cx - ex, cy - ey))
    hi = np.maximum(hi, (cx + ex, cy + ey))
    found = True
  return (lo, hi) if found else None


# ------------------------------------------------------------- param grids

def _gridTris(nu, nv, occ):
  '''Triangle indices over an (nu+1, nv+1) vertex grid, keeping cells whose
  three corners are occupied. Azimuth grids are seam-closed by the
  duplicated phi=0/2pi vertex column, so no wrap handling is needed.'''
  cols = nv + 1
  tris = []
  for i in range(nu):
    for j in range(nv):
      a, b = i * cols + j, i * cols + j + 1
      c, d = (i + 1) * cols + j, (i + 1) * cols + j + 1
      if occ[a] and occ[b] and occ[c]:
        tris.append((a, b, c))
      if occ[b] and occ[d] and occ[c]:
        tris.append((b, d, c))
  return tris


def _finite(lo, hi, cap):
  lo = -cap if not np.isfinite(lo) else lo
  hi = cap if not np.isfinite(hi) else hi
  return float(lo), float(hi)


def _bandRange(surf, trim, cap):
  '''The v-band (z, or r for aspheres) to grid over. Bitmap-trimmed faces
  carry the real window ONLY in trimBitmap (brep zeroes trim[1..2] and
  reuses the row for the UV->pixel map) — reading trim there collapses
  the whole grid to a zero-extent sliver at v=0.'''
  if 'trimBitmap' in surf:
    bm = surf['trimBitmap']
    R = np.asarray(bm['mask']).shape[0]
    return float(bm['v0']), float(bm['v0'] + R / bm['invDv'])
  return _finite(trim[1], trim[2], cap)


def tessellateSurface(surf, resolution=48, infiniteExtent=150.):
  '''Mesh one analytic surface record into (verts (V, 3), tris (T, 3)) in
  WORLD coordinates. Unbounded trims (infinite plane radius / z band) are
  capped at `infiniteExtent`. Returns empty arrays for kinds/param
  combinations with no closed-form chart (warned once).'''
  kind = int(surf['kind'])
  params = np.asarray(surf['params'], dtype=float)
  trim = np.asarray(surf['trim'], dtype=float)
  res = int(resolution)
  phi = np.linspace(0., 2 * np.pi, res + 1)
  baseOk = None        # plane grids extended over ADD tabs set a real one

  if kind == S.KIND_CODES['triangle']:
    verts = params[:9].reshape(3, 3)
    return _toWorld(surf, verts), np.array([[0, 1, 2]])

  if kind == S.KIND_CODES['plane']:
    if 'trimBitmap' in surf:
      bm = surf['trimBitmap']
      R = np.asarray(bm['mask']).shape[0]
      x = np.linspace(bm['u0'], bm['u0'] + R / bm['invDu'], res + 1)
      y = np.linspace(bm['v0'], bm['v0'] + R / bm['invDv'], res + 1)
      X, Y = np.meshgrid(x, y, indexing='ij')
    elif trim[0] in (1., 4.):                     # rect half-extents
      xlo, xhi, ylo, yhi = -trim[1], trim[1], -trim[2], trim[2]
      ext = _addPrimBounds(surf)
      if ext is not None:           # cover protruding boolean-ADD tabs
        xlo, ylo = np.minimum((xlo, ylo), ext[0])
        xhi, yhi = np.maximum((xhi, yhi), ext[1])
      x = np.linspace(xlo, xhi, res + 1)
      y = np.linspace(ylo, yhi, res + 1)
      X, Y = np.meshgrid(x, y, indexing='ij')
    else:                                         # ring rMin..rMax
      rMin, rMax = trim[1], trim[2]
      rMax = infiniteExtent if not np.isfinite(rMax) else rMax
      ext = _addPrimBounds(surf)
      if ext is not None:           # cover protruding boolean-ADD tabs
        corners = np.array([[ext[0][0], ext[0][1]], [ext[0][0], ext[1][1]],
                            [ext[1][0], ext[0][1]], [ext[1][0], ext[1][1]]])
        rMax = max(rMax, float(np.sqrt((corners ** 2).sum(axis=1)).max()))
      r = np.linspace(max(rMin, 0.), rMax, res + 1)
      X = np.cos(phi)[:, None] * r[None, :]
      Y = np.sin(phi)[:, None] * r[None, :]
    pts = np.stack([X, Y, np.zeros_like(X)], axis=-1)
    u, v = pts[..., 0], pts[..., 1]
    # real base-window test (grids may extend past it over ADD tabs);
    # mirrors surfaces._trimPlane: rect for modes 1/4, ring otherwise
    # (a tiny tolerance keeps the grid's own boundary vertices occupied)
    tol = 1e-9 * max(1., float(np.abs(trim[1:3]).max()))
    if 'trimBitmap' in surf:
      baseOk = None
    elif trim[0] in (1., 4.):
      baseOk = (np.abs(X) <= trim[1] + tol) & (np.abs(Y) <= trim[2] + tol)
    else:
      rr = np.sqrt(X * X + Y * Y)
      rMaxB = trim[2] if np.isfinite(trim[2]) else np.inf
      baseOk = (trim[1] - tol <= rr) & (rr <= rMaxB + tol)

  elif kind == S.KIND_CODES['sphere']:
    R = params[0]
    b1, b2 = _bandRange(surf, trim, R)
    z1, z2 = np.clip(b1, -R, R), np.clip(b2, -R, R)
    th = np.linspace(np.arccos(np.clip(z2 / R, -1, 1)),
                     np.arccos(np.clip(z1 / R, -1, 1)), res + 1)
    sth = np.sin(th)
    pts = np.stack([R * np.cos(phi)[:, None] * sth[None, :],
                    R * np.sin(phi)[:, None] * sth[None, :],
                    np.broadcast_to(R * np.cos(th), (res + 1, res + 1))],
                   axis=-1)
    u = _chartU(pts)
    v = pts[..., 2]

  elif kind == S.KIND_CODES['cylinder']:
    R = params[0]
    z1, z2 = _bandRange(surf, trim, infiniteExtent)
    z = np.linspace(z1, z2, res + 1)
    pts = np.stack([R * np.cos(phi)[:, None] * np.ones_like(z)[None, :],
                    R * np.sin(phi)[:, None] * np.ones_like(z)[None, :],
                    np.broadcast_to(z, (res + 1, res + 1))], axis=-1)
    u, v = _chartU(pts), pts[..., 2]

  elif kind == S.KIND_CODES['cone']:
    r0, tanA = params[0], params[1]
    z1, z2 = _bandRange(surf, trim, infiniteExtent)
    z = np.linspace(z1, z2, res + 1)
    r = np.maximum(r0 + z * tanA, 0.)
    pts = np.stack([np.cos(phi)[:, None] * r[None, :],
                    np.sin(phi)[:, None] * r[None, :],
                    np.broadcast_to(z, (res + 1, res + 1))], axis=-1)
    u, v = _chartU(pts), pts[..., 2]

  elif kind == S.KIND_CODES['asphere']:
    rMin, rMax = _bandRange(surf, trim, infiniteExtent) \
        if 'trimBitmap' in surf else (trim[1], trim[2])
    if not np.isfinite(rMax):
      c = abs(params[0])
      rMax = (0.999 / (c * max(1. + params[1], 1e-9) ** .5)
              if c > 1e-12 else infiniteExtent)
      rMax = min(rMax, infiniteExtent)
    r = np.linspace(max(rMin, 0.), rMax, res + 1)
    r2 = r * r
    c, k = params[0], params[1]
    root = np.sqrt(np.maximum(1 - (1 + k) * c * c * r2, 1e-12))
    sag = c * r2 / (1 + root) + r2 * r2 * (params[2] + r2 * (
        params[3] + r2 * params[4]))
    pts = np.stack([np.cos(phi)[:, None] * r[None, :],
                    np.sin(phi)[:, None] * r[None, :],
                    np.broadcast_to(sag, (res + 1, res + 1))], axis=-1)
    u, v = _chartU(pts), np.broadcast_to(r, pts.shape[:-1])

  elif kind == S.KIND_CODES['quadric']:
    qa, qb, qc, qz, q0 = params[:5]
    if qa <= 0 or qb <= 0:
      io.warn(f'tessellate: quadric with non-positive x/y coefficients '
              f'({qa:g}, {qb:g}) has no revolution chart; skipped')
      return np.zeros((0, 3)), np.zeros((0, 3), dtype=int)
    z1, z2 = _bandRange(surf, trim, infiniteExtent)
    z = np.linspace(z1, z2, res + 1)
    val = -(q0 + qz * z + qc * z * z)
    good = val >= 0     # the == 0 rim is the real pole of a closed quadric
    rx = np.sqrt(np.maximum(val, 0.) / qa)
    ry = np.sqrt(np.maximum(val, 0.) / qb)
    pts = np.stack([np.cos(phi)[:, None] * rx[None, :],
                    np.sin(phi)[:, None] * ry[None, :],
                    np.broadcast_to(z, (res + 1, res + 1))], axis=-1)
    u, v = _chartU(pts), pts[..., 2]
    occ = _vertexOk(surf, pts, u, v) & good[None, :]
    return _assemble(surf, pts, occ, res, res)

  elif kind == S.KIND_CODES['torus']:
    R0, rT = params[0], params[1]
    if 'trimBitmap' in surf:
      v1, v2 = -np.pi, np.pi
    else:
      v1, v2 = max(trim[1], -np.pi), min(trim[2], np.pi)
    vv = np.linspace(v1, v2, res + 1)
    rad = R0 + rT * np.cos(vv)
    pts = np.stack([np.cos(phi)[:, None] * rad[None, :],
                    np.sin(phi)[:, None] * rad[None, :],
                    np.broadcast_to(rT * np.sin(vv), (res + 1, res + 1))],
                   axis=-1)
    u, v = _chartU(pts), np.broadcast_to(vv, pts.shape[:-1])

  else:
    io.warn(f'tessellate: unknown surface kind {kind}; skipped')
    return np.zeros((0, 3)), np.zeros((0, 3), dtype=int)

  occ = _vertexOk(surf, pts, u, v, baseOk=baseOk)
  return _assemble(surf, pts, occ, res, res)


def _chartU(pts):
  return np.arctan2(pts[..., 1], pts[..., 0])


def _toWorld(surf, verts):
  m = np.asarray(surf['transform'], dtype=float)
  return verts @ m[:3, :3].T + m[:3, 3]


def _assemble(surf, pts, occ, nu, nv):
  V = pts.reshape(-1, 3)
  tris = _gridTris(nu, nv, occ.reshape(-1))
  if not tris:
    return np.zeros((0, 3)), np.zeros((0, 3), dtype=int)
  tris = np.asarray(tris, dtype=int)
  used = np.unique(tris)
  remap = np.full(len(V), -1, dtype=int)
  remap[used] = np.arange(len(used))
  return _toWorld(surf, V[used]), remap[tris]


# ------------------------------------------------------------ scene export

def tessellateScene(scene, resolution=48, infiniteExtent=150.):
  '''[(groupLabel, color, verts, tris), ...] over every group placement —
  the same instance expansion as Scene.compile (models/scene.py:112-121).'''
  out = []
  for group in scene.opticalObjects():
    color = tuple(getattr(group, 'ViewColor', None) or (0.35, 0.35, 0.4))
    for placement in group.placements:
      for spec in group.surfaces:
        inst = dict(spec)
        inst['transform'] = np.asarray(placement, dtype=float) @ \
            np.asarray(spec['transform'], dtype=float)
        verts, tris = tessellateSurface(inst, resolution=resolution,
                                        infiniteExtent=infiniteExtent)
        if len(tris):
          out.append((group.Label, color, verts, tris))
  return out


def plotScene(scene, ax=None, drawnRays=None, resolution=24,
              infiniteExtent=150., alpha=0.3, maxRays=300):
  '''Matplotlib 3-D view of the tessellated scene (per-element ViewColor,
  translucent) with optional drawn rays over it — the notebook analog of
  the reference's FreeCAD viewport.'''
  import matplotlib.pyplot as plt
  from mpl_toolkits.mplot3d.art3d import Poly3DCollection
  if ax is None:
    ax = plt.figure().add_subplot(projection='3d')
  lo = np.full(3, np.inf)
  hi = np.full(3, -np.inf)
  for _label, color, v, t in tessellateScene(scene, resolution=resolution,
                                             infiniteExtent=infiniteExtent):
    ax.add_collection3d(Poly3DCollection(
        v[t], facecolors=[tuple(color) + (alpha,)],
        edgecolors='none'))
    lo = np.minimum(lo, v.min(axis=0))
    hi = np.maximum(hi, v.max(axis=0))
  if drawnRays is not None and drawnRays.rayCount:
    drawnRays.plot(ax=ax, maxRays=maxRays)
    lo = np.minimum(lo, drawnRays.points.min(axis=0))
    hi = np.maximum(hi, drawnRays.points.max(axis=0))
  if np.isfinite(lo).all():
    pad = 0.05 * max(float((hi - lo).max()), 1.)
    ax.set_xlim(lo[0] - pad, hi[0] + pad)
    ax.set_ylim(lo[1] - pad, hi[1] + pad)
    ax.set_zlim(lo[2] - pad, hi[2] + pad)
  ax.set_xlabel('x'), ax.set_ylabel('y'), ax.set_zlabel('z')
  return ax


def writeScenePLY(scene, path, resolution=48, infiniteExtent=150.,
                  drawnRays=None):
  '''One ASCII PLY holding the tessellated scene (per-element vertex
  colors) and, when `drawnRays` (a simulation.draw.DrawnRays) is given,
  the colored ray polylines as edge elements — the full headless analog
  of the reference's 3D view in a single file.'''
  pieces = tessellateScene(scene, resolution=resolution,
                           infiniteExtent=infiniteExtent)
  verts, colors, faces = [], [], []
  off = 0
  for _label, color, v, t in pieces:
    verts.append(v)
    colors.append(np.broadcast_to(np.asarray(color, dtype=float), v.shape))
    faces.append(t + off)
    off += len(v)
  nRayVerts = nEdges = 0
  rayV = rayC = None
  if drawnRays is not None and drawnRays.rayCount:
    rayV = drawnRays.points
    rayC = drawnRays.vertexColors()
    nRayVerts = len(rayV)
    nEdges = drawnRays.segmentCount
  V = np.concatenate(verts) if verts else np.zeros((0, 3))
  C = np.concatenate(colors) if colors else np.zeros((0, 3))
  F = np.concatenate(faces) if faces else np.zeros((0, 3), dtype=int)
  from ..simulation.draw import plyVertexBlock, plyEdgeBlock
  with open(path, 'w') as f:
    f.write('ply\nformat ascii 1.0\n'
            'comment optics_design_workbench scene\n'
            f'element vertex {len(V) + nRayVerts}\n'
            'property float x\nproperty float y\nproperty float z\n'
            'property uchar red\nproperty uchar green\n'
            'property uchar blue\n'
            f'element face {len(F)}\n'
            'property list uchar int vertex_indices\n'
            f'element edge {nEdges}\n'
            'property int vertex1\nproperty int vertex2\n'
            'end_header\n')
    f.write(plyVertexBlock(V, C))
    if nRayVerts:
      f.write(plyVertexBlock(rayV, rayC))
    if len(F):
      import io as _io
      buf = _io.StringIO()
      np.savetxt(buf, F, fmt='3 %d %d %d')
      f.write(buf.getvalue())
    if nEdges:
      f.write(plyEdgeBlock(drawnRays.offsets, indexOffset=len(V)))
  io.verb(f'wrote scene mesh ({len(V)} verts, {len(F)} faces'
          + (f', {nEdges} ray edges' if nEdges else '') + f') to {path}')
  return path
