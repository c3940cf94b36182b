'''
Analytic surface tables — the device-side replacement for OpenCASCADE BRep.

The reference's hot loop calls FreeCAD/OCC per ray and per face
(`line.Curve.intersect(surface)`, `face.normalAt`, bbox tests — reference:
freecad_elements/ray.py:340-383, 403-428; simulation/raytracing_cache.py).
Here the scene is compiled once into SoA arrays of trimmed analytic surfaces
(plane / sphere / cylinder / asphere / triangle), each carrying its rigid
world<->local transform and the optical-element id it belongs to. Closed-form
(or Newton, for aspheres) intersection and normals are evaluated in batch
with `vmap` on device.

Surface encoding
================
kind (int32):
  0 PLANE     local z=0 plane.
  1 SPHERE    centered at local origin, radius params[0] (>0).
  2 CYLINDER  axis = local z, radius params[0].
  3 ASPHERE   sag surface z = c*r^2/(1+sqrt(1-(1+k)*c^2*r^2)) + a4 r^4 +
              a6 r^6 + a8 r^8 with c=params[0] (curvature, 1/R), k=params[1],
              a4..a8 = params[2:5]. Covers conics (parabola k=-1, sphere k=0).
  4 TRIANGLE  vertices in params[0:9] (local frame usually identity).
  5 CONE      axis = local z, radius(z) = params[0] + z * params[1]
              (params[1] = tan of the semi-angle; OCC cone analog).
  6 QUADRIC   principal-axis quadric f(p) = qa x^2 + qb y^2 + qc z^2 +
              qz z + q0 = 0 with (qa, qb, qc, qz, q0) = params[0:5].
              Covers ellipsoids (non-uniformly scaled spheres), elliptic
              cylinders, elliptic/hyperbolic paraboloids and hyperboloids
              exactly — the closed forms behind OCC b-spline faces produced
              by Part::Scale / affine booleans (geometry/brep.py fits them
              back at ingest so the device never traces their
              tessellation).
  7 TORUS     tube radius params[1] around the circle of radius params[0]
              in the local z=0 plane (OCC gp_Torus; exact quartic
              intersection, Ferrari + Newton polish).

trim (float32[6]): per-kind trim window (OCC face trimming analog,
ray.py:375-382):
  PLANE:    trim[0] shape flag (0=annulus, 1=rectangle);
            annulus: r in [trim[1], trim[2]]; rect: |x|<=trim[1], |y|<=trim[2]
  SPHERE:   z in [trim[1], trim[2]] (cap/zone selection)
  CYLINDER: z in [trim[1], trim[2]]
  ASPHERE:  r in [trim[1], trim[2]]
  CONE:     z in [trim[1], trim[2]]
  QUADRIC:  z in [trim[1], trim[2]]
  TORUS:    tube angle v = atan2(z, sqrt(x^2+y^2) - R) in [trim[1], trim[2]]
  TRIANGLE: unused (barycentric test is the trim)

Bitmap trims: trim[0] == 2 selects a per-face UV occupancy bitmap instead
of the closed-form window (exact OCC face boundaries that are neither
rectangles, discs, annuli nor parameter bands — e.g. a boolean-cut slot;
built by geometry/brep.py). trim[1:5] = (u0, v0, 1/du, 1/dv) map the
kind's UV chart onto bitmap pixels: plane (x, y); sphere/cylinder/cone
(atan2(y, x), z); asphere (atan2(y, x), r). The bitmaps ride along as a
`trimMask` array per kind slice; scenes without bitmap trims never touch
them (kernels take mask=None and skip the gather entirely).

Trim-primitive trims: trim[0] == 3 (band/annulus base, trim[1:3] as the
trim[0] == 0 window) and trim[0] == 4 (rect base, plane only, trim[1:3]
as the trim[0] == 1 window) subtract a short list of HOLE primitives from
the closed-form base: occupied = base AND NOT any(hole). Holes are exact
rotated rectangles or discs evaluated on the surface's LOCAL (x, y)
coordinates at the candidate hit (a vertical boolean cut through ANY of
the kinds projects to exactly such a shape), packed as a (maxHoles, 7)
float row per surface: (flag 1=rect/2=disc, cx, cy, p0, p1, cosA, sinA)
with rect half-extents (p0, p1) and disc radius^2 in p0. Built by
geometry/brep._fitTrimPrims from boolean-cut CAD faces (e.g. the
reference example 2's slotted mirrors) — exact where a 192-px bitmap is
approximate, and ~5 VPU ops per hole instead of a bitmap gather.

orient (float32, +1/-1): multiplies the canonical normal to yield the
*outward-of-solid* normal, which defines the entering/exiting decision
(ray.py:403-428). Canonical normals: plane +z, sphere radially out, cylinder
radially out, asphere grad(z - sag(r)) (points to +z side), triangle
right-handed winding.
'''

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import transforms

PLANE, SPHERE, CYLINDER, ASPHERE, TRIANGLE, CONE, QUADRIC, TORUS = \
    0, 1, 2, 3, 4, 5, 6, 7
N_PARAMS, N_TRIM = 9, 6
_KIND_NAMES = {0: 'plane', 1: 'sphere', 2: 'cylinder', 3: 'asphere',
               4: 'triangle', 5: 'cone', 6: 'quadric', 7: 'torus'}
KIND_CODES = {name: code for code, name in _KIND_NAMES.items()}


# --------------------------------------------------------- host-side builders

def _surf(kind, params, trim, transform, elem, orient):
  p = np.zeros(N_PARAMS)
  p[:len(params)] = params
  t = np.zeros(N_TRIM)
  t[:len(trim)] = trim
  return dict(kind=kind, params=p, trim=t,
              transform=np.asarray(transform, dtype=float),
              elem=elem, orient=float(orient))


def plane(transform, elem, radius=None, innerRadius=0., halfExtents=None,
          orient=+1):
  '''Disc/annulus (radius given) or rectangle (halfExtents given) in the
  local z=0 plane.'''
  if halfExtents is not None:
    trim = (1., halfExtents[0], halfExtents[1])
  else:
    trim = (0., innerRadius, np.inf if radius is None else radius)
  return _surf(PLANE, (), trim, transform, elem, orient)


def sphere(transform, elem, radius, zRange=None, orient=+1):
  '''Full sphere or z-trimmed zone/cap of radius `radius` centered at the
  local origin.'''
  if zRange is None:
    zRange = (-radius, radius)
  return _surf(SPHERE, (radius,), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def cylinder(transform, elem, radius, zRange, orient=+1):
  return _surf(CYLINDER, (radius,), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def asphere(transform, elem, curvature, conic=0., coeffs=(0., 0., 0.),
            rMax=np.inf, rMin=0., orient=+1):
  '''Even asphere sag surface; curvature = 1/R at the vertex.'''
  a = tuple(coeffs) + (0.,) * (3 - len(coeffs))
  return _surf(ASPHERE, (curvature, conic) + a, (0., rMin, rMax),
               transform, elem, orient)


def triangle(v0, v1, v2, elem, orient=+1):
  return _surf(TRIANGLE, tuple(v0) + tuple(v1) + tuple(v2), (),
               np.eye(4), elem, orient)


def cone(transform, elem, radius, tanAngle, zRange, orient=+1):
  '''Cone of local radius(z) = radius + z * tanAngle (OCC gp_Cone analog).'''
  return _surf(CONE, (radius, tanAngle), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def quadric(transform, elem, coeffs, zRange, orient=+1):
  '''Principal-axis quadric qa x^2 + qb y^2 + qc z^2 + qz z + q0 = 0 with
  coeffs = (qa, qb, qc, qz, q0), trimmed to z in zRange. Canonical normal =
  +grad f; orient flips it to outward-of-solid.'''
  qa, qb, qc, qz, q0 = coeffs
  return _surf(QUADRIC, (qa, qb, qc, qz, q0), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def torus(transform, elem, majorRadius, minorRadius, vRange=None, orient=+1):
  '''Torus around the local z axis: tube of radius `minorRadius` swept
  along the circle of radius `majorRadius` in the z=0 plane (OCC gp_Torus
  analog; reference faces of this kind reach the tracer through
  line.Curve.intersect, ray.py:357-383). The trim band is the TUBE angle
  v = atan2(z, sqrt(x^2+y^2) - majorRadius) in (-pi, pi]: v = 0 is the
  outer equator, +/-pi the inner equator, +pi/2 the top circle. vRange
  None keeps the full tube. Requires majorRadius > minorRadius (OCC's
  non-self-intersecting regime). orient +1 = outward of the solid tube.'''
  if vRange is None:
    vRange = (-3.15, 3.15)
  return _surf(TORUS, (majorRadius, minorRadius),
               (0., vRange[0], vRange[1]), transform, elem, orient)


def _conicAsQuadric(s):
  '''Rewrite an exact-conic ASPHERE (a4 = a6 = a8 = 0) as a QUADRIC row.

  The conic sag z = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) satisfies the
  principal-axis quadric -c x^2 - c y^2 - c (1+k) z^2 + 2 z = 0 exactly,
  so the 16-iteration Newton solve in _intersectAsphere collapses to one
  closed-form quadratic — ~10x fewer arithmetic ops per bounce for paraboloid /
  spherical-cap faces (reference example 2's dish mirror; the reference
  delegates the same intersection to OCC's exact gp-quadric classes,
  ray.py:357-383). The radial trim r in [trim1, trim2] maps to the z band
  [sag(r1), sag(r2)] (the sag is monotone on its branch), clamped to the
  branch apex z = 1/(c (1+k)) for k > -1 so the far sheet of the closed
  ellipsoid stays excluded. The quadric canonical normal +grad f with this
  sign choice equals grad(z - sag) at the vertex, so `orient` carries over
  unchanged. Bitmap-trimmed faces keep the ASPHERE (azimuth, r) chart.'''
  if s['kind'] != ASPHERE or 'trimBitmap' in s:
    return s
  p = np.asarray(s['params'], dtype=float)
  c, k = float(p[0]), float(p[1])
  if abs(c) < 1e-12 or np.any(p[2:5] != 0.):
    return s
  trim = np.array(s['trim'], dtype=float)
  if trim[0] == 2.:
    return s
  r1, r2 = float(trim[1]), float(trim[2])
  if k > -1.:
    rNat = 1. / (abs(c) * np.sqrt(1. + k))
    r1, r2 = min(r1, rNat), min(r2, rNat)

  def sag(r):
    q = max(1. - (1. + k) * c * c * r * r, 0.)
    return c * r * r / (1. + np.sqrt(q))
  out = dict(s)
  out['kind'] = QUADRIC
  q = np.zeros(N_PARAMS)
  q[:5] = (-c, -c, -c * (1. + k), 2., 0.)
  out['params'] = q
  if np.isfinite(r2):
    trim[1], trim[2] = sorted((sag(r1), sag(r2)))
  else:
    # k <= -1 with unbounded rMax (k > -1 is always clamped finite at
    # rNat above): the sag branch is single-sheet and monotone unbounded
    # on the sign(c) side of z = 0, while the conjugate sheet of a k < -1
    # hyperboloid lies entirely beyond its apex z = -2/(c (1+k)) on the
    # OPPOSITE z side — so a one-sided infinite z band is an exact trim
    # and these faces keep the closed-form quadratic instead of falling
    # back to the Newton ASPHERE path.
    if not np.isfinite(r1):
      return s
    zNear = sag(r1)
    trim[1], trim[2] = (zNear, np.inf) if c > 0 else (-np.inf, zNear)
  out['trim'] = trim
  return out


def buildSurfaceTable(surfs, dtype=jnp.float32, devicePut=True):
  '''Pack a list of surface dicts into a SoA device table (a pytree dict).
  With devicePut=False the table stays host-side numpy (used by the batched
  sweep, which stacks many variant tables and ships them as ONE jit
  argument instead of one device_put per variant).

  Surfaces are SORTED BY KIND and the table carries a `byKind` sub-dict of
  contiguous per-kind slices: the intersection sweep dispatches one
  vectorized kernel per kind present instead of a `lax.switch` per surface
  (a vmapped switch evaluates every branch for every ray x surface — with
  the Newton-iteration asphere branch that costs ~20x on scenes without
  aspheres).'''
  if not surfs:
    raise ValueError('scene contains no surfaces')
  surfs = [_conicAsQuadric(s) for s in surfs]
  surfs = sorted(surfs, key=lambda s: s['kind'])
  # bitmap trims (exact-BRep face boundaries, geometry/brep.py): pack every
  # face bitmap into one zero-padded (S, R, R) stack; surfaces without a
  # bitmap get an all-ones row (their trim flag never selects it). The trim
  # row of a bitmap face encodes its own UV->pixel map, so zero padding
  # beyond a smaller bitmap's own resolution correctly reads "outside".
  # trim-primitive holes (geometry/brep._fitTrimPrims): pack every
  # surface's hole list into one zero-padded (S, maxHoles, 7) array;
  # surfaces without holes get all-zero rows (flag 0 = inactive).
  primSurfs = [(i, s) for i, s in enumerate(surfs) if 'trimPrims' in s]
  primStack = None
  if primSurfs:
    maxH = max(len(s['trimPrims']['holes']) for _i, s in primSurfs)
    primStack = np.zeros((len(surfs), maxH, 7), dtype=np.float32)
    for i, s in primSurfs:
      for h, hole in enumerate(s['trimPrims']['holes']):
        primStack[i, h, :len(hole)] = hole
  bitmapSurfs = [(i, s) for i, s in enumerate(surfs) if 'trimBitmap' in s]
  maskStack = None
  maskIdx = None
  if bitmapSurfs:
    res = max(s['trimBitmap']['mask'].shape[0] for _i, s in bitmapSurfs)
    maskStack = np.zeros((len(bitmapSurfs), res, res), dtype=np.uint8)
    maskIdx = np.zeros(len(surfs), dtype=np.int32)
    for row, (i, s) in enumerate(bitmapSurfs):
      bm = s['trimBitmap']
      m = bm['mask']
      maskStack[row, :m.shape[0], :m.shape[1]] = m
      maskIdx[i] = row
      s['trim'] = np.array([2., bm['u0'], bm['v0'], bm['invDu'],
                            bm['invDv'], 0.])
  mats = np.stack([s['transform'] for s in surfs])
  matsInv = np.stack([np.linalg.inv(m) for m in mats])
  # Snap world->local rotations onto exact signed-permutation groups
  # (faces of one rigid part share a base rotation up to axis perm/sign):
  # a sweep may hoist ONE ray rotation per group per bounce and the
  # grouped arithmetic is bit-identical to the per-surface form BECAUSE the
  # snapped rows are exact sign-copies. The frame ORIGIN (local->world
  # translation) is held fixed; both transform directions are rebuilt from
  # the snapped rotation so they stay exact inverses.
  snapped, _gids = transforms.snapSignedPermGroups(matsInv[:, :3, :3])
  for i in range(len(surfs)):
    tl = mats[i, :3, 3]                      # frame origin in world: keep
    matsInv[i, :3, :3] = snapped[i]
    matsInv[i, :3, 3] = -snapped[i] @ tl
    mats[i, :3, :3] = snapped[i].T
  w2lRot, w2lOff = transforms.rotRowsOffsets(matsInv, dtype=np.float32)
  l2wRot, l2wOff = transforms.rotRowsOffsets(mats, dtype=np.float32)
  npDtype = np.dtype(dtype.dtype if hasattr(dtype, 'dtype') else dtype)
  # assemble EVERYTHING in numpy and transfer each array exactly once:
  # slicing/converting device arrays here would dispatch one tiny XLA
  # compile per op, which costs ~0.5 s each over a remote-compile link
  # (~20 s of scene-compile latency for a 5-surface scene)
  host = dict(
      kind=np.asarray([s['kind'] for s in surfs], dtype=np.int32),
      params=np.stack([s['params'] for s in surfs]).astype(npDtype),
      trim=np.stack([s['trim'] for s in surfs]).astype(npDtype),
      w2lRot=np.asarray(w2lRot, dtype=npDtype),
      w2lOff=np.asarray(w2lOff, dtype=npDtype),
      l2wRot=np.asarray(l2wRot, dtype=npDtype),
      l2wOff=np.asarray(l2wOff, dtype=npDtype),
      elem=np.asarray([s['elem'] for s in surfs], dtype=np.int32),
      orient=np.asarray([s['orient'] for s in surfs], dtype=npDtype),
  )
  table = dict(host)
  kinds = host['kind']
  byKind = {}
  for kind in sorted(set(kinds.tolist())):
    sel = np.nonzero(kinds == kind)[0]
    start, stop = int(sel[0]), int(sel[-1]) + 1
    byKind[_KIND_NAMES[kind]] = {
        k: host[k][start:stop]
        for k in ('params', 'trim', 'w2lRot', 'w2lOff')}
    if maskIdx is not None and (host['trim'][start:stop, 0] == 2.).any():
      byKind[_KIND_NAMES[kind]]['trimMaskIdx'] = maskIdx[start:stop]
    if primStack is not None and (host['trim'][start:stop, 0] > 2.5).any():
      byKind[_KIND_NAMES[kind]]['trimPrims'] = primStack[start:stop]
  table['byKind'] = byKind
  if maskStack is not None:
    table['trimMasks'] = maskStack
    table['trimMaskIdx'] = maskIdx
  if primStack is not None:
    table['trimPrims'] = primStack
  # packed per-surface row for the post-selection hot path: ONE (N, K)
  # gather instead of many small-minor-dim (N,3,3) gathers + matvecs
  # layout: w2lRot (9, row-major), w2lOff (3), orient, elem, kind, params (9)
  rotFlat = np.asarray(matsInv[:, :3, :3].reshape(len(surfs), 9))
  packed = np.concatenate([
      rotFlat,
      np.asarray(matsInv[:, :3, 3]),
      np.asarray([[s['orient']] for s in surfs]),
      np.asarray([[float(s['elem'])] for s in surfs]),
      np.asarray([[float(s['kind'])] for s in surfs]),
      np.stack([s['params'] for s in surfs]),
  ], axis=1)
  table['packed'] = packed.astype(npDtype)
  # ONE batched host->device transfer for the whole table instead of one
  # transfer per array
  if devicePut:
    table = jax.device_put(table)
  # host copy of the (kind-sorted) element indices so callers never pay a
  # device->host fetch during compilation
  table['_hostElem'] = host['elem']
  return table


# column offsets in table['packed']
PACKED_ROT, PACKED_OFF, PACKED_ORIENT = 0, 9, 12
PACKED_ELEM, PACKED_KIND, PACKED_PARAMS = 13, 14, 15


def numSurfaces(table):
  return table['kind'].shape[0]


# -------------------------------------------------------- intersection kernel

_BIG = jnp.inf


def chartAtan2(y, x):
  '''Branchless Cephes-style atan2 (4-term minimax after octant/half-angle
  reduction; error <~1 ulp f32 of pi). Used for the bitmap-trim azimuth
  chart by both tracers (via _trimBandOk); sharing ONE formula keeps the
  per-ray and batch paths' pixel indices bit-identical instead of
  diverging by an ulp at pixel boundaries. Bitmap CONTENT is
  baked with np.arctan2 (geometry/brep._deviceUV) — a sub-ulp chart offset
  relative to the bake shifts nothing at the bitmap's own 1/192 pixel
  scale.'''
  ax, ay = jnp.abs(x), jnp.abs(y)
  hi = jnp.maximum(ax, ay)
  lo = jnp.minimum(ax, ay)
  a = lo / jnp.maximum(hi, 1e-30)
  big = a > 0.41421356237309503     # tan(pi/8): half-angle reduction
  aa = jnp.where(big, (a - 1.) / (a + 1.), a)
  z = aa * aa
  p = ((8.05374449538e-2 * z - 1.38776856032e-1) * z
       + 1.99777106478e-1) * z - 3.33329491539e-1
  p = p * z * aa + aa
  p = jnp.where(big, p + 0.7853981633974483, p)
  p = jnp.where(ay > ax, 1.5707963267948966 - p, p)
  p = jnp.where(x < 0, jnp.pi - p, p)
  return jnp.where(y < 0, -p, p)


def _maskLookup(trim, mask, u, v):
  '''Bitmap trim sample: maps UV-chart coordinates onto the (R, R) face
  occupancy bitmap (v-major). Conservative clip at the window border.'''
  R = mask.shape[0]
  iu = jnp.clip(jnp.floor((u - trim[1]) * trim[3]).astype(jnp.int32),
                0, R - 1)
  iv = jnp.clip(jnp.floor((v - trim[2]) * trim[4]).astype(jnp.int32),
                0, R - 1)
  inWindow = ((u - trim[1]) * trim[3] >= 0) \
      & ((u - trim[1]) * trim[3] < R) \
      & ((v - trim[2]) * trim[4] >= 0) \
      & ((v - trim[2]) * trim[4] < R)
  return inWindow & (mask[iv, iu] > 0)


def _applyPrims(prims, x, y, z, baseOk):
  '''Boolean-cut trim algebra: occupied = (base OR any add-prim) AND NOT
  any hole-prim. prims is a (maxPrims, 7) row per surface:
  (flag, cx, cy, p0, p1, cosA, sinA). flag = shape + 10*isAdd +
  20*isInverted with shapes 1 rect (rotated half-extents p0, p1), 2 disc
  (radius^2 in p0), 3 half-plane ((x-cx, y-cy).(p0, p1) >= 0), 4 poly2
  (yr <= p0*xr^2 + p1*xr in the rotated frame — the planar cut of a conic
  neighbor face), 5 general conic (payload = (A, B, C, D, E, F), inside =
  A x^2 + B xy + C y^2 + D x + E y + F <= 0 — elliptic/hyperbolic
  boolean-cut boundaries in any position);
  6 half-SPACE on the full local point (p0, p1, cosA, sinA as the plane
  normal (nx, ny, nz) and offset c: nx*x + ny*y + nz*z >= c — tilted
  planar cuts of revolution/quadric faces whose rims are not v-bands);
  flag 0 = inactive. Inverted prims test the shape complement ("keep
  inside the neighbor's arc" boolean intersections).'''
  addHit = x != x                    # all-false without materializing bools
  holeHit = x != x
  for h in range(prims.shape[0]):
    row = prims[h]
    isInv = row[0] > 15.5
    rem = row[0] - jnp.where(isInv, 20., 0.)
    isAdd = rem > 5.5
    shape = rem - jnp.where(isAdd, 10., 0.)
    dxp, dyp = x - row[1], y - row[2]
    xr = row[5] * dxp + row[6] * dyp
    yr = -row[6] * dxp + row[5] * dyp
    rectIn = (jnp.abs(xr) <= row[3]) & (jnp.abs(yr) <= row[4])
    discIn = dxp * dxp + dyp * dyp <= row[3]
    halfIn = dxp * row[3] + dyp * row[4] >= 0
    polyIn = yr <= row[3] * xr * xr + row[4] * xr
    conicIn = (row[1] * x * x + row[2] * x * y + row[3] * y * y
               + row[4] * x + row[5] * y + row[6]) <= 0.
    spaceIn = x * row[1] + y * row[2] + z * row[3] >= row[4]
    inP = jnp.where(shape > 5.5, spaceIn,
                    jnp.where(shape > 4.5, conicIn,
                              jnp.where(shape > 3.5, polyIn,
                                        jnp.where(shape > 2.5, halfIn,
                                                  jnp.where(shape > 1.5,
                                                            discIn,
                                                            rectIn)))))
    inP = (inP != isInv) & (row[0] > 0.5)
    addHit = addHit | (inP & isAdd)
    holeHit = holeHit | (inP & ~isAdd)
  return (baseOk | addHit) & ~holeHit


def _trimBandOk(trim, mask, p, v, prims=None):
  '''Shared trim for the axis-symmetric kinds: closed-form band
  trim[1] <= v <= trim[2]; the UV bitmap when trim[0] == 2 (u = azimuth);
  band minus local-(x, y) hole primitives when trim[0] == 3.'''
  band = (trim[1] <= v) & (v <= trim[2])
  if prims is not None:
    band = jnp.where(trim[0] > 2.5,
                     _applyPrims(prims, p[0], p[1], p[2], band), band)
  if mask is None:
    return band
  u = chartAtan2(p[1], p[0])
  return jnp.where(trim[0] == 2., _maskLookup(trim, mask, u, v), band)


def _trimPlane(trim, p, mask=None, prims=None):
  isRect = (trim[0] == 1.) | (trim[0] == 4.)
  rect = (jnp.abs(p[0]) <= trim[1]) & (jnp.abs(p[1]) <= trim[2])
  r = jnp.sqrt(p[0] ** 2 + p[1] ** 2)
  ring = (trim[1] <= r) & (r <= trim[2])
  closed = jnp.where(isRect, rect, ring)
  if prims is not None:
    closed = jnp.where(trim[0] > 2.5,
                       _applyPrims(prims, p[0], p[1], p[2], closed),
                       closed)
  if mask is None:
    return closed
  return jnp.where(trim[0] == 2., _maskLookup(trim, mask, p[0], p[1]),
                   closed)


def _intersectPlane(params, trim, o, d, tMin, mask=None, prims=None):
  dz = jnp.where(jnp.abs(d[2]) < 1e-12, 1e-12, d[2])
  t = -o[2] / dz
  p = o + t * d
  ok = (t > tMin) & _trimPlane(trim, p, mask, prims)
  return jnp.where(ok, t, _BIG)


def _quadraticRoots(a, b, c):
  '''Numerically stable roots of a t^2 + b t + c, returned sorted; NaN-free
  (invalid -> +inf).'''
  disc = b * b - 4 * a * c
  ok = disc >= 0
  # double-where: sqrt'(0) is inf, so a plain sqrt(maximum(disc, 0)) turns
  # every MISSING ray's zero-clamped discriminant into 0*inf = NaN under
  # reverse-mode AD (tracing/diff.py differentiates through this sweep)
  sq = jnp.where(ok, jnp.sqrt(jnp.where(ok, disc, 1.)), 0.)
  q = -0.5 * (b + jnp.sign(b + 1e-30) * sq)
  aSafe = jnp.where(jnp.abs(a) < 1e-20, 1e-20, a)
  t1 = q / aSafe
  qSafe = jnp.where(jnp.abs(q) < 1e-20, 1e-20, q)
  t2 = c / qSafe
  lo, hi = jnp.minimum(t1, t2), jnp.maximum(t1, t2)
  return jnp.where(ok, lo, _BIG), jnp.where(ok, hi, _BIG)


def _pickRoot(t1, t2, valid1, valid2):
  '''Smallest valid root, else +inf.'''
  t1 = jnp.where(valid1, t1, _BIG)
  t2 = jnp.where(valid2, t2, _BIG)
  return jnp.minimum(t1, t2)


def _intersectSphere(params, trim, o, d, tMin, mask=None, prims=None):
  R = params[0]
  b = 2 * jnp.dot(o, d)
  c = jnp.dot(o, o) - R * R
  t1, t2 = _quadraticRoots(jnp.dot(d, d), b, c)

  def zOk(t):
    p = o + t * d
    return _trimBandOk(trim, mask, p, p[2], prims)

  return _pickRoot(t1, t2, (t1 > tMin) & zOk(t1), (t2 > tMin) & zOk(t2))


def _intersectCylinder(params, trim, o, d, tMin, mask=None, prims=None):
  R = params[0]
  a = d[0] ** 2 + d[1] ** 2
  b = 2 * (o[0] * d[0] + o[1] * d[1])
  c = o[0] ** 2 + o[1] ** 2 - R * R
  t1, t2 = _quadraticRoots(a, b, c)

  def zOk(t):
    p = o + t * d
    return _trimBandOk(trim, mask, p, p[2], prims)

  return _pickRoot(t1, t2, (t1 > tMin) & zOk(t1), (t2 > tMin) & zOk(t2))


def _intersectCone(params, trim, o, d, tMin, mask=None, prims=None):
  '''Cone |(x, y)| = r0 + z*tanA (OCC gp_Cone analog; params = (r0, tanA)).
  Quadratic in t with the linear radius term w(t) = w0 + t*wd; only the
  nappe with w >= 0 is real surface.'''
  r0, tanA = params[0], params[1]
  w0 = r0 + o[2] * tanA
  wd = d[2] * tanA
  a = d[0] ** 2 + d[1] ** 2 - wd * wd
  b = 2 * (o[0] * d[0] + o[1] * d[1] - w0 * wd)
  c = o[0] ** 2 + o[1] ** 2 - w0 * w0
  t1, t2 = _quadraticRoots(a, b, c)

  def ok(t):
    p = o + t * d
    return (w0 + t * wd >= 0) & _trimBandOk(trim, mask, p, p[2], prims)

  return _pickRoot(t1, t2, (t1 > tMin) & ok(t1), (t2 > tMin) & ok(t2))


def _sag(params, r2):
  c, k = params[0], params[1]
  a4, a6, a8 = params[2], params[3], params[4]
  root = jnp.sqrt(jnp.maximum(1 - (1 + k) * c * c * r2, 1e-12))
  return c * r2 / (1 + root) + r2 * r2 * (a4 + r2 * (a6 + r2 * a8))


def _sagPrimeOverR(params, r2):
  '''d(sag)/dr / r — well defined at r=0.'''
  c, k = params[0], params[1]
  a4, a6, a8 = params[2], params[3], params[4]
  root = jnp.sqrt(jnp.maximum(1 - (1 + k) * c * c * r2, 1e-12))
  # d/dr [c r^2/(1+root)] / r = c*(2/(1+root) + c^2(1+k) r^2/(root (1+root)^2))
  base = c * (2 / (1 + root) + (1 + k) * c * c * r2 / (root * (1 + root) ** 2))
  poly = 4 * a4 * r2 + 6 * a6 * r2 * r2 + 8 * a8 * r2 ** 3
  return base + poly


def _intersectAsphere(params, trim, o, d, tMin, mask=None, prims=None):
  '''Newton iterations on f(t) = z(t) - sag(r(t)); seeded at the tangent
  plane (or best-fit sphere when curvature dominates). Finds the first
  crossing in the common optics regime (one intersection per ray within the
  aperture).'''
  c = params[0]
  # initial guess: intersect the vertex tangent plane z=0; fall back to the
  # osculating sphere when the plane is parallel
  dz = jnp.where(jnp.abs(d[2]) < 1e-9, jnp.sign(d[2] + 1e-30) * 1e-9, d[2])
  t0Plane = -o[2] / dz
  # osculating sphere: center (0,0,R) radius R (when c != 0)
  R = 1. / jnp.where(jnp.abs(c) < 1e-12, 1e-12, c)
  oc = o - jnp.array([0., 0., 1.]) * R
  b = 2 * jnp.dot(oc, d)
  cc = jnp.dot(oc, oc) - R * R
  s1, s2 = _quadraticRoots(jnp.dot(d, d), b, cc)
  sSphere = _pickRoot(s1, s2, s1 > tMin, s2 > tMin)
  t = jnp.where(jnp.isfinite(t0Plane) & (jnp.abs(c) < 1e-12), t0Plane,
                jnp.where(jnp.isfinite(sSphere), sSphere, t0Plane))
  t = jnp.maximum(t, 0.)

  def body(i, t):
    p = o + t * d
    r2 = p[0] ** 2 + p[1] ** 2
    f = p[2] - _sag(params, r2)
    dfdr_over_r = _sagPrimeOverR(params, r2)
    grad = jnp.array([-dfdr_over_r * p[0], -dfdr_over_r * p[1], 1.])
    slope = jnp.dot(grad, d)
    slope = jnp.where(jnp.abs(slope) < 1e-12, jnp.sign(slope + 1e-30) * 1e-12,
                      slope)
    return t - f / slope

  t = lax.fori_loop(0, 24, body, t)
  p = o + t * d
  r2 = p[0] ** 2 + p[1] ** 2
  resid = jnp.abs(p[2] - _sag(params, r2))
  r = jnp.sqrt(r2)
  ok = ((t > tMin) & (resid < 1e-4) & _trimBandOk(trim, mask, p, r, prims)
        & jnp.isfinite(t))
  return jnp.where(ok, t, _BIG)


def _intersectQuadric(params, trim, o, d, tMin, mask=None, prims=None):
  '''f(o + t d) = 0 is an exact quadratic in t for the principal-axis
  quadric — same cost class as a sphere. The stable-roots helper also
  covers the degenerate linear case (|a| -> 0: grazing a paraboloid along
  its axis): the surviving root comes out of the c/q branch.'''
  qa, qb, qc, qz, q0 = params[0], params[1], params[2], params[3], params[4]
  a = qa * d[0] ** 2 + qb * d[1] ** 2 + qc * d[2] ** 2
  b = 2 * (qa * o[0] * d[0] + qb * o[1] * d[1] + qc * o[2] * d[2]) \
      + qz * d[2]
  c = (qa * o[0] ** 2 + qb * o[1] ** 2 + qc * o[2] ** 2
       + qz * o[2] + q0)
  t1, t2 = _quadraticRoots(a, b, c)
  # linear fallback: a ~ 0 with b != 0 has the single root -c/b
  linT = -c / jnp.where(jnp.abs(b) < 1e-20, 1e-20, b)
  isLin = (jnp.abs(a) < 1e-14 * (jnp.abs(b) + 1e-20)) & (jnp.abs(b) > 1e-20)
  t1 = jnp.where(isLin, linT, t1)
  t2 = jnp.where(isLin, _BIG, t2)

  def zOk(t):
    p = o + t * d
    return _trimBandOk(trim, mask, p, p[2], prims)

  return _pickRoot(t1, t2, (t1 > tMin) & zOk(t1), (t2 > tMin) & zOk(t2))


def _cubicLargestRoot(B, C, D):
  '''Largest real root of S^3 + B S^2 + C S + D = 0 by damped Newton from
  ABOVE the Cauchy root bound — monotone global convergence to the largest
  root (the cubic is convex and increasing there), entirely branch-free
  with no acos/cbrt. Used by the quartic
  factorization below, where D = -q^2 <= 0 guarantees a root >= 0.'''
  S = 1. + jnp.maximum(jnp.abs(B), jnp.maximum(jnp.abs(C), jnp.abs(D)))
  for _ in range(28):
    f = ((S + B) * S + C) * S + D
    fp = (3. * S + 2. * B) * S + C
    fp = jnp.where(jnp.abs(fp) < 1e-20, 1e-20, fp)
    step = f / fp
    # never step past the root from above: f > 0 and fp > 0 on the
    # approach, so a plain Newton step is already monotone; the clamp
    # only guards the pathological flat-slope start
    S = S - jnp.clip(step, -jnp.abs(S) - 1., jnp.abs(S) + 1.)
  return S


def _quarticSmallestRoot(b, c, d, e, tMin, validFn):
  '''Smallest root t > tMin of t^4 + b t^3 + c t^2 + d t + e with
  validFn(t) true, else _BIG. Ferrari-style factorization into two
  quadratics via the resolvent cubic, every candidate polished with three
  Newton steps on the quartic itself (f32-safe for simple roots; double
  roots — grazing rays — land within ~sqrt(eps) like every tracer's
  quadric grazing case).'''
  # depress: t = u - b/4
  b4 = b / 4.
  p = c - 3. * b * b / 8.
  q = d - b * c / 2. + b ** 3 / 8.
  r = e - b * d / 4. + b * b * c / 16. - 3. * b ** 4 / 256.
  # factor u^4 + p u^2 + q u + r = (u^2 + s u + A)(u^2 - s u + Bb):
  # S = s^2 solves S^3 + 2p S^2 + (p^2 - 4r) S - q^2 = 0 (root >= 0 exists)
  S = jnp.maximum(_cubicLargestRoot(2. * p, p * p - 4. * r, -q * q), 0.)
  biquad = S < 1e-10 * (1. + jnp.abs(p))   # q ~ 0: u^4 + p u^2 + r
  # sqrt on a masked-safe value: sqrt'(0) = inf would 0*inf-NaN the
  # cotangent under reverse-mode AD even though the biquad branch never
  # uses s (same trap as _quadraticRoots' double-where)
  s = jnp.sqrt(jnp.where(biquad, 1., S))
  sSafe = jnp.where(biquad, 1., s)
  A = 0.5 * (p + S - q / sSafe)
  Bb = 0.5 * (p + S + q / sSafe)
  # biquadratic fallback: u^2 = y with y^2 + p y + r = 0
  y1, y2 = _quadraticRoots(jnp.ones_like(p), p, r)
  A = jnp.where(biquad, jnp.where(y1 < _BIG, -y1, 0.), A)
  Bb = jnp.where(biquad, jnp.where(y2 < _BIG, -y2, 0.), Bb)
  sQ = jnp.where(biquad, 0., s)
  u1, u2 = _quadraticRoots(jnp.ones_like(p), sQ, A)
  u3, u4 = _quadraticRoots(jnp.ones_like(p), -sQ, Bb)

  tBest = jnp.full_like(p, _BIG)
  for u in (u1, u2, u3, u4):
    t = jnp.where(u < _BIG, u - b4, _BIG)
    for _ in range(3):                     # Newton polish on the quartic
      f = (((t + b) * t + c) * t + d) * t + e
      fp = ((4. * t + 3. * b) * t + 2. * c) * t + d
      fp = jnp.where(jnp.abs(fp) < 1e-20, 1e-20, fp)
      t = jnp.where(t < _BIG, t - f / fp, t)
    ok = (t > tMin) & (t < _BIG) & validFn(t)
    tBest = jnp.minimum(tBest, jnp.where(ok, t, _BIG))
  return tBest


def _intersectTorus(params, trim, o, d, tMin, mask=None, prims=None):
  '''Ray-torus intersection: exact quartic (Ferrari + Newton polish).
  Implicit form g(p) = (|p|^2 + R^2 - r^2)^2 - 4 R^2 (x^2 + y^2) = 0.
  The ray is re-anchored at its closest approach to the torus center
  before expanding the quartic — with |o'| ~ R the f32 coefficients stay
  small enough for the factorization to hold ~1e-3 absolute root error,
  and the Newton polish takes it to ulp for simple roots. Trim band is
  the tube angle v (see `torus`), so caps/inner-half selections are
  closed-form; bitmap/prim trims ride the shared machinery.'''
  R, r = params[0], params[1]
  # unit-less conditioning: anchor at closest approach, scale by R
  dd = jnp.dot(d, d)
  tMid = -jnp.dot(o, d) / jnp.where(dd < 1e-20, 1e-20, dd)
  oS = (o + tMid * d) / R
  dS = d / jnp.sqrt(dd)
  rr = r / R
  # quartic in the scaled parameter tau: t = tMid + tau * R / |d|
  K = jnp.dot(oS, oS) + 1. - rr * rr
  bq = 2. * jnp.dot(oS, dS)
  exy = dS[0] ** 2 + dS[1] ** 2
  fxy = oS[0] * dS[0] + oS[1] * dS[1]
  gxy = oS[0] ** 2 + oS[1] ** 2
  b = 2. * bq
  c = bq * bq + 2. * K - 4. * exy
  dL = 2. * bq * K - 8. * fxy
  e = K * K - 4. * gxy

  def valid(tau):
    t = tMid + tau * R / jnp.sqrt(dd)
    pt = o + t * d
    sxy = jnp.sqrt(pt[0] ** 2 + pt[1] ** 2)
    # residual gate: reject spurious factorization roots (g ~ 2 r delta)
    g = (sxy - R) ** 2 + pt[2] ** 2 - r * r
    v = chartAtan2(pt[2], sxy - R)
    return (jnp.abs(g) < 2e-3 * r * r + 1e-6 * R * R) \
        & _trimBandOk(trim, mask, pt, v, prims)

  tauMin = (tMin - tMid) * jnp.sqrt(dd) / R
  tau = _quarticSmallestRoot(b, c, dL, e, tauMin, valid)
  t = tMid + tau * R / jnp.sqrt(dd)
  return jnp.where(tau < _BIG, t, _BIG)


def _intersectTriangle(params, trim, o, d, tMin, mask=None, prims=None):
  v0 = params[0:3]
  e1 = params[3:6] - v0
  e2 = params[6:9] - v0
  # Moeller-Trumbore
  pvec = jnp.cross(d, e2)
  det = jnp.dot(e1, pvec)
  detSafe = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
  tvec = o - v0
  u = jnp.dot(tvec, pvec) / detSafe
  qvec = jnp.cross(tvec, e1)
  v = jnp.dot(d, qvec) / detSafe
  t = jnp.dot(e2, qvec) / detSafe
  ok = ((jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
        & (t > tMin))
  return jnp.where(ok, t, _BIG)


KIND_INTERSECTORS = {
    'plane': _intersectPlane, 'sphere': _intersectSphere,
    'cylinder': _intersectCylinder, 'asphere': _intersectAsphere,
    'triangle': _intersectTriangle, 'cone': _intersectCone,
    'quadric': _intersectQuadric, 'torus': _intersectTorus}


@functools.lru_cache(maxsize=4)
def _intersectLocalSwitch(hasMask, hasPrims):
  '''Jitted 8-way kind switch, cached on which optional trim extras ride
  along. Caching + jit is load-bearing, not a micro-optimization: building
  fresh branch lambdas per call makes eager `lax.switch` retrace AND
  recompile its cond program on EVERY call (~37 MB RSS leaked each — a
  test looping intersectLocal 300x segfaulted the CPU backend with LLVM
  "Cannot allocate memory"). The jitted closure pins one C++-fastpath
  entry per (mask?, prims?) combination.'''
  fns = [_intersectPlane, _intersectSphere, _intersectCylinder,
         _intersectAsphere, _intersectTriangle, _intersectCone,
         _intersectQuadric, _intersectTorus]

  @jax.jit
  def run(kind, params, trim, o, d, tMin, mask, prims):
    branches = [lambda p, t, oo, dd, tm, mk, pr, f=f:
                f(p, t, oo, dd, tm,
                  mask=(mk if hasMask else None),
                  prims=(pr if hasPrims else None))
                for f in fns]
    return lax.switch(kind, branches, params, trim, o, d, tMin, mask,
                      prims)
  return run


def intersectLocal(kind, params, trim, o, d, tMin, mask=None, prims=None):
  '''Nearest valid intersection parameter t of a local-frame ray with one
  surface; +inf when there is none. Switch-based single-surface form; the
  batched sweep uses the per-kind kernels directly (see
  intersect.allDistances). mask/prims (bitmap / hole-primitive trims) ride
  as ordinary operands — absent extras cost nothing (a scalar zero rides
  in their place).'''
  zero = jnp.zeros(())
  return _intersectLocalSwitch(mask is not None, prims is not None)(
      kind, params, trim, o, d, tMin,
      zero if mask is None else mask,
      zero if prims is None else prims)


def _normalBranches():
  def nPlane(params, p):
    return jnp.array([0., 0., 1.])

  def nSphere(params, p):
    return transforms.normalize(p)

  def nCylinder(params, p):
    return transforms.normalize(jnp.array([p[0], p[1], 0.]))

  def nAsphere(params, p):
    r2 = p[0] ** 2 + p[1] ** 2
    g = _sagPrimeOverR(params, r2)
    return transforms.normalize(jnp.array([-g * p[0], -g * p[1], 1.]))

  def nTriangle(params, p):
    e1 = params[3:6] - params[0:3]
    e2 = params[6:9] - params[0:3]
    return transforms.normalize(jnp.cross(e1, e2))

  def nCone(params, p):
    r = jnp.sqrt(p[0] ** 2 + p[1] ** 2)
    rSafe = jnp.where(r < 1e-12, 1e-12, r)
    return transforms.normalize(jnp.array(
        [p[0] / rSafe, p[1] / rSafe, -params[1]]))

  def nQuadric(params, p):
    return transforms.normalize(jnp.array(
        [2 * params[0] * p[0], 2 * params[1] * p[1],
         2 * params[2] * p[2] + params[3]]))

  def nTorus(params, p):
    # geometric: (p - tube-circle center) / r; s > 0 on the surface for
    # the non-self-intersecting R > r regime
    R = params[0]
    s = jnp.sqrt(p[0] ** 2 + p[1] ** 2)
    sSafe = jnp.where(s < 1e-12, 1e-12, s)
    scale = R / sSafe
    return transforms.normalize(jnp.array(
        [p[0] * (1. - scale), p[1] * (1. - scale), p[2]]))

  return [nPlane, nSphere, nCylinder, nAsphere, nTriangle, nCone,
          nQuadric, nTorus]


_NORMAL_BRANCHES = _normalBranches()


@jax.jit
def normalLocal(kind, params, p):
  '''Canonical (un-oriented) unit surface normal at local point p. Jitted
  with module-level branches so repeated eager calls reuse one compiled
  switch (see _intersectLocalSwitch for why this is load-bearing).'''
  return lax.switch(kind, _NORMAL_BRANCHES, params, p)
