'''
Placement / transform math.

Replaces the reference's reliance on FreeCAD `Placement.toMatrix` /
`Matrix.inverse` / `Rotation` arithmetic (reference:
freecad_elements/common.py:112-125, ray.py passim, point_source.py:426-428)
with plain 4x4 affine matrices (host, float64) and Rodrigues rotations
(device, jnp). Placements are rigid (rotation + translation); one object may
occur at several global transforms (App::Link semantics, common.py:36-47) —
the scene compiler simply emits one surface instance per placement.
'''

import numpy as np
import jax.numpy as jnp


def identity():
  return np.eye(4)


def translation(x, y, z):
  m = np.eye(4)
  m[:3, 3] = (x, y, z)
  return m


def rotation(axis, angleDeg):
  '''Right-handed rotation about `axis` by `angleDeg` degrees, as a 4x4
  matrix (FreeCAD `Rotation(axis, angle)` semantics).'''
  axis = np.asarray(axis, dtype=float)
  axis = axis / np.linalg.norm(axis)
  a = np.deg2rad(float(angleDeg))
  c, s = np.cos(a), np.sin(a)
  x, y, z = axis
  K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
  R = np.eye(3) + s * K + (1 - c) * (K @ K)
  m = np.eye(4)
  m[:3, :3] = R
  return m


def placement(position=(0, 0, 0), axis=(0, 0, 1), angleDeg=0.):
  '''FreeCAD-style placement: rotate about axis through the origin, then
  translate to position.'''
  m = rotation(axis, angleDeg)
  m[:3, 3] = position
  return m


def compose(*matrices):
  out = np.eye(4)
  for m in matrices:
    out = out @ np.asarray(m, dtype=float)
  return out


def invert(m):
  return np.linalg.inv(np.asarray(m, dtype=float))


def applyToPoints(m, points):
  '''Apply a 4x4 affine to an (..., 3) array of points (host numpy).'''
  m = np.asarray(m, dtype=float)
  points = np.asarray(points, dtype=float)
  return points @ m[:3, :3].T + m[:3, 3]


def applyToDirections(m, dirs):
  m = np.asarray(m, dtype=float)
  dirs = np.asarray(dirs, dtype=float)
  return dirs @ m[:3, :3].T


def rotRowsOffsets(matrices, dtype=np.float32):
  '''Split a stack of 4x4 matrices into (rot (N,3,3), offset (N,3)) device
  arrays.'''
  # NUMPY outputs on purpose: scene compilation assembles everything on
  # host and transfers once (device arrays here would make
  # buildSurfaceTable's np.asarray(..., dtype) round-trips compile a tiny
  # convert program each).
  m = np.asarray(matrices, dtype=float)
  return (m[..., :3, :3].astype(dtype), m[..., :3, 3].astype(dtype))


def snapSignedPermGroups(rots, tol=2e-6):
  '''Snap a stack of (N, 3, 3) rotation matrices onto exact signed-axis-
  permutation equivalence classes.

  Surfaces of one rigid part (a box housing's six faces, a lens barrel's
  caps and wall, ...) carry world->local rotations that differ only by an
  axis permutation and sign flips of the SAME base rotation — but each was
  composed through its own placement chain, so the relation holds only to
  float rounding. This pass greedily groups rows whose relative rotation
  `R_i @ R_g.T` is within `tol` of a signed permutation matrix P and
  rewrites each member as EXACTLY `P @ R_g` (row-wise sign-copies of the
  representative — exact in IEEE arithmetic). A per-surface sweep can
  then rotate the ray into each GROUP frame once per bounce and derive every member's local frame with free sign/axis picks,
  bit-identically to the per-surface form.

  The snap moves each rotation by at most ~tol (default 2e-6, well below
  any optically meaningful tilt; deliberate misalignments are orders of
  magnitude larger and keep their own group). Returns (snapped (N, 3, 3)
  float64, groupIds (N,) int). Disable with ODW_SNAP_FRAMES=0.'''
  import os
  R = np.array(rots, dtype=float)
  n = len(R)
  gid = np.full(n, -1, dtype=int)
  if os.environ.get('ODW_SNAP_FRAMES', '1') == '0':
    return R, np.arange(n)
  reps = [None]                # group 0: the world frame (axis-aligned rows
  for i in range(n):           # snap to exact 0/+-1 entries — free picks)
    for g, rep in enumerate(reps):
      M = R[i] if rep is None else R[i] @ R[rep].T
      P = np.round(M)
      if (np.max(np.abs(M - P)) <= tol
          and np.array_equal(np.abs(P).sum(axis=0), np.ones(3))
          and np.array_equal(np.abs(P).sum(axis=1), np.ones(3))):
        R[i] = P if rep is None else P @ R[rep]  # exact signed row copies
        gid[i] = g
        break
    if gid[i] < 0:
      gid[i] = len(reps)
      reps.append(i)
  return R, gid


# ------------------------------------------------------------- device helpers

def rodrigues(v, axis, angle):
  '''Rotate vector(s) v about unit axis by angle (radians); jnp, broadcasts
  over leading axes. Replaces FreeCAD `Rotation(axis, deg) * vec`.'''
  axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
  c = jnp.cos(angle)[..., None] if jnp.ndim(angle) else jnp.cos(angle)
  s = jnp.sin(angle)[..., None] if jnp.ndim(angle) else jnp.sin(angle)
  cross = jnp.cross(axis, v)
  dot = jnp.sum(axis * v, axis=-1, keepdims=True)
  return v * c + cross * s + axis * dot * (1 - c)


def normalize(v, eps=1e-20):
  return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True) + eps)
