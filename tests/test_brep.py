'''
BRep ASCII parser + analytic face extraction tests (geometry/brep.py),
validated against the reference project files' evaluated OCC geometry
(reference: freecad_elements/ray.py:357-383 intersects these exact trimmed
surfaces through FreeCAD/OCC).
'''

import os
import zipfile

import numpy as np
import pytest

from optics_design_workbench.geometry import brep as B
from optics_design_workbench.geometry import surfaces as S

_EX2 = '/root/reference/examples/2-lens-and-mirror/main.FCStd'
_LAMBERT = '/root/reference/test/50-old-tests/lambert-source.FCStd'


def _blob(fcstd, name):
  if not os.path.exists(fcstd):
    pytest.skip('reference FCStd not available')
  with zipfile.ZipFile(fcstd) as z:
    return z.read(name).decode('latin-1')


def _kinds(surfs):
  out = {}
  for s in surfs:
    out[s['kind']] = out.get(s['kind'], 0) + 1
  return out


def test_box_is_six_exact_rects():
  surfs, notes = B.brepToSurfaces(_blob(_EX2, 'Box.Shape.brp'), elem=0)
  assert _kinds(surfs) == {S.PLANE: 6}
  assert all(n == 'rect' for n in notes)
  # slot box is Length 3 x Width 18 x Height 40: exact half extents
  halfExtents = sorted({(round(float(s['trim'][1]), 6),
                         round(float(s['trim'][2]), 6)) for s in surfs})
  dims = {d for he in halfExtents for d in he}
  assert dims == {1.5, 9.0, 20.0}, halfExtents


def test_sphere_full_zrange():
  surfs, notes = B.brepToSurfaces(_blob(_EX2, 'Sphere.Shape.brp'), elem=0)
  assert _kinds(surfs) == {S.SPHERE: 1}
  s = surfs[0]
  R = float(s['params'][0])
  assert R == pytest.approx(20.)
  assert float(s['trim'][1]) <= -R * .999 and float(s['trim'][2]) >= R * .999


def test_lens_common_sphere_cap_cylinder_disc():
  '''Common = Sphere(R20) AND Cylinder(R9, z>=14): spherical cap (zRange),
  cylinder band, flat disc.'''
  surfs, notes = B.brepToSurfaces(_blob(_EX2, 'Common.Shape.brp'), elem=0)
  assert _kinds(surfs) == {S.SPHERE: 1, S.CYLINDER: 1, S.PLANE: 1}
  cap = next(s for s in surfs if s['kind'] == S.SPHERE)
  # cap above the cylinder intersection circle: z in [sqrt(20^2-9^2), 20]
  zLo = np.sqrt(20. ** 2 - 9. ** 2)
  assert float(cap['trim'][1]) == pytest.approx(zLo, abs=.3)
  disc = next(s for s in surfs if s['kind'] == S.PLANE)
  assert float(disc['trim'][0]) == 0.          # annulus/disc flag
  assert float(disc['trim'][2]) == pytest.approx(9., abs=.01)


def test_revolve_paraboloid_exact():
  '''Revolve = parabola meridian around the y axis -> ASPHERE k=-1 whose
  sag matches the OCC revolution surface to float precision.'''
  text = _blob(_EX2, 'Revolve.Shape.brp')
  surfs, notes = B.brepToSurfaces(text, elem=0)
  asph = next(s for s in surfs if s['kind'] == S.ASPHERE)
  assert float(asph['params'][1]) == -1.
  br = B.parseBRep(text)
  rec = next(r for r in br.surfaces if r['type'] == 'revolution')
  P = B.evalSurface(rec, np.linspace(0, 2 * np.pi, 9),
                    np.linspace(.5, 20, 7)).reshape(-1, 3)
  inv = np.linalg.inv(asph['transform'])
  pl = P @ inv[:3, :3].T + inv[:3, 3]
  c = float(asph['params'][0])
  r2 = pl[:, 0] ** 2 + pl[:, 1] ** 2
  sag = c * r2 / 2.                       # parabola: k=-1
  assert np.abs(pl[:, 2] - sag).max() < 1e-9


def test_cut_slot_becomes_trim_prims():
  '''The boolean slot through the parabolic mirror classifies as EXACT
  trim primitives (r-band base minus a rect strip hole,
  geometry/brep._fitTrimPrims) — no bitmap discretization: the slot strip
  is excluded at every radius, the rest of the zone is included.'''
  surfs, notes = B.brepToSurfaces(_blob(_EX2, 'Cut.Shape.brp'), elem=0)
  asph = next(s for s in surfs if s['kind'] == S.ASPHERE)
  assert 'trimBitmap' not in asph, notes
  assert float(asph['trim'][0]) == 3.          # band base + prims
  holes = asph['trimPrims']['holes']
  assert holes, notes
  rects = [h for h in holes if h[0] == 1.]
  assert rects, f'expected a rect strip hole, got {holes}'

  def occupied(x, y):
    r = np.hypot(x, y)
    ok = (asph['trim'][1] <= r) & (r <= asph['trim'][2])
    for f, cx, cy, p0, p1, ca, sa in holes:
      xr = ca * (x - cx) + sa * (y - cy)
      yr = -sa * (x - cx) + ca * (y - cy)
      if f == 1.:
        ok = ok & ~((np.abs(xr) <= p0) & (np.abs(yr) <= p1))
      elif f == 3.:
        ok = ok & ~((x - cx) * p0 + (y - cy) * p1 >= 0)
    return ok
  f, cx, cy, hx, hy, ca, sa = rects[0]
  t = np.linspace(-min(hx, 19.), min(hx, 19.), 41)
  assert not occupied(cx + t * ca, cy + t * sa).any(), \
      'the slot strip must be excluded along its whole length'
  s = np.linspace(hy + 1., 19., 29)        # perpendicular, past the strip
  assert occupied(cx - s * sa, cy + s * ca).all(), \
      'the zone away from the slot must be included'


def test_cone_record_and_kind():
  surfs, notes = B.brepToSurfaces(_blob(_LAMBERT, 'Cone.Shape.brp'), elem=0)
  kinds = _kinds(surfs)
  assert kinds.get(S.CONE) == 1, (kinds, notes)
  cone = next(s for s in surfs if s['kind'] == S.CONE)
  # Cone.Shape: r=2 at z=0, semiangle atan(-2) -> radius 0 at z=1
  assert float(cone['params'][0]) == pytest.approx(2.)
  assert float(cone['params'][1]) == pytest.approx(-2., abs=1e-6)


def test_scaled_lens_refits_as_quadrics():
  '''Part::Scale with a non-uniform factor produces elliptic NURBS; the
  rational periodic bsplines must evaluate without NaNs and the faces must
  refit as EXACT quadrics (ellipsoid dome + elliptic cylinder rim) instead
  of tessellating — 12824 Moeller-Trumbore triangles collapse to 2 closed
  forms (reference traces the OCC NURBS directly, ray.py:357-383).'''
  text = _blob(_EX2, 'Scale.Shape.brp')
  br = B.parseBRep(text)
  rec = next(r for r in br.surfaces if r['type'] == 'bspline')
  pts = B.evalSurface(rec, np.linspace(rec['uknots'][0], rec['uknots'][-1],
                                       17),
                      np.linspace(rec['vknots'][0], rec['vknots'][-1], 5))
  assert np.isfinite(pts).all()
  surfs, notes = B.brepToSurfaces(text, elem=0, tessRes=16)
  kinds = _kinds(surfs)
  assert kinds.get(S.TRIANGLE, 0) == 0, (kinds, notes)
  assert kinds.get(S.QUADRIC, 0) >= 2, (kinds, notes)
  # the source solid is Scale(2, 4, 3) of a radius-20 sphere body: the
  # ellipsoid face must recover semi-axes {40, 80, 60} and the scaled
  # cylindrical rim {18, 36} (r=9 cylinder scaled in-plane), exactly
  semiAxes = []
  for s in surfs:
    if s['kind'] != S.QUADRIC:
      continue
    qa, qb, qc, qz, q0 = [float(v) for v in s['params'][:5]]
    assert abs(qz) < 1e-6
    axes = sorted(np.sqrt(-q0 / np.array([v for v in (qa, qb, qc)
                                          if v > 1e-9])))
    semiAxes.append(tuple(round(a, 3) for a in axes))
  assert any(set(a) == {40., 60., 80.} for a in semiAxes), semiAxes
  assert any(set(a) == {18., 36.} for a in semiAxes), semiAxes


def test_exact_nurbs_sphere_detected_in_eval():
  '''One of the Scale faces is an exact NURBS sphere (R=20, untouched by
  the anisotropic scale along its symmetry): evaluation must reproduce it
  to float precision.'''
  text = _blob(_EX2, 'Scale.Shape.brp')
  br = B.parseBRep(text)
  best = np.inf
  for rec in br.surfaces:
    if rec['type'] != 'bspline':
      continue
    u = np.linspace(rec['uknots'][0], rec['uknots'][-1], 21)
    v = np.linspace(rec['vknots'][0], rec['vknots'][-1], 7)
    pts = B.evalSurface(rec, u, v).reshape(-1, 3)
    A = np.concatenate([2 * pts, np.ones((len(pts), 1))], axis=1)
    b = (pts ** 2).sum(axis=1)
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    c = sol[:3]
    R = np.sqrt(sol[3] + c @ c)
    best = min(best, np.abs(np.linalg.norm(pts - c, axis=1) - R).max())
  assert best < 1e-9


def test_slot_trim_device_intersections():
  '''Device-side boolean-cut trims (trimPrims): rays aimed at the slot vs
  the mirror zone of the Cut paraboloid hit exactly where the solid
  says.'''
  import jax
  import jax.numpy as jnp
  from optics_design_workbench.geometry import intersect as I
  surfs, _notes = B.brepToSurfaces(_blob(_EX2, 'Cut.Shape.brp'), elem=0)
  table = S.buildSurfaceTable([dict(s) for s in surfs])
  assert 'trimPrims' in table
  # central ray passes through the slot: no asphere hit
  o = jnp.zeros(3)
  dC = jnp.array([0., 0., 1.])
  tC = np.asarray(I.allDistances(table, o, dC, 1e-6))
  kinds = np.asarray(table['kind'])
  # the conic paraboloid is refit to an exact QUADRIC at table build
  # (surfaces._conicAsQuadric); select the DISH specifically — the
  # quadric/asphere row carrying the boolean-cut trim prims — so a
  # legitimate hit on any other quadric brep might fit in this scene
  # can never fail the slot assertion spuriously
  trimKind = np.asarray(table['trim'])[:, 0]
  dish = np.isin(kinds, (S.ASPHERE, S.QUADRIC)) & (trimKind == 3.)
  assert dish.any()
  assert not np.isfinite(tC[dish]).any()
  # off-axis ray hits the mirror zone
  dO = jnp.array([.15, 0., .99])
  dO = dO / jnp.linalg.norm(dO)
  tO = np.asarray(I.allDistances(table, o, dO, 1e-6))
  assert np.isfinite(tO[dish]).any()


def test_all_reference_fcstds_parse():
  '''Every .brp blob in every reference FCStd parses and yields faces.'''
  import glob
  files = glob.glob('/root/reference/**/*.FCStd', recursive=True)
  if not files:
    pytest.skip('reference not available')
  parsed, failed = 0, []
  for f in files:
    with zipfile.ZipFile(f) as z:
      for n in z.namelist():
        if not n.endswith('.brp'):
          continue
        text = z.read(n).decode('latin-1')
        if 'TShapes' not in text:
          continue
        try:
          br = B.parseBRep(text)
          parsed += 1
        except Exception as e:
          failed.append((os.path.basename(f), n, str(e)))
  assert parsed > 50
  assert not failed, failed[:5]


def test_reference_corpus_classification_census():
  '''Classification regression guard across every reference FCStd: the
  closed-form paths (rect/disc/band/zRange/trim-prims/quadric) must keep
  covering the corpus — new bitmap or tessellation fallbacks on these
  files mean a fitter regression (geometry/brep._fitTrimPrims).'''
  import collections
  import glob
  files = glob.glob('/root/reference/**/*.FCStd', recursive=True)
  if not files:
    pytest.skip('reference not available')
  # per-file ceilings for the APPROXIMATE fallbacks, measured 2026-08-17
  # (the STEP-imported surface-source part is genuinely freeform)
  bitmapCeiling = {'imported-stepfile-as-surface-source.FCStd': 42,
                   'lambert-source.FCStd': 1, 'lens-overlap.FCStd': 2}
  tessCeiling = {'imported-stepfile-as-surface-source.FCStd': 8}
  for f in sorted(files):
    name = f.rsplit('/', 1)[-1]
    cnt = collections.Counter()
    with zipfile.ZipFile(f) as z:
      for n in z.namelist():
        if not n.endswith('.brp'):
          continue
        text = z.read(n).decode('latin-1')
        if 'TShapes' not in text:
          continue
        try:
          _surfs, notes = B.brepToSurfaces(text, elem=0)
        except ValueError:
          continue                    # no-geometry blobs
        for note in notes:
          cnt[note.split('(')[0].strip()] += 1
    assert cnt.get('bitmap trim', 0) <= bitmapCeiling.get(name, 0), \
        (name, dict(cnt))
    assert cnt.get('tessellated bspline', 0) + cnt.get(
        'tessellated torus', 0) <= tessCeiling.get(name, 0), \
        (name, dict(cnt))


def test_step_import_tori_load_analytic():
  '''The STEP-imported surface-source part carries 3 torus records; they
  must now ingest as analytic TORUS surfaces (kind 7) instead of the
  pre-round-4 triangle tessellations (reference delegates tori to OCC,
  ray.py:357-383; brep torus records are CASCADE type 5).'''
  import collections
  import glob
  files = [p for p in glob.glob('/root/reference/**/*.FCStd', recursive=True)
           if 'imported-stepfile' in p]
  if not files:
    pytest.skip('reference not available')
  cnt = collections.Counter()
  torus = 0
  with zipfile.ZipFile(files[0]) as z:
    for n in z.namelist():
      if not n.endswith('.brp'):
        continue
      text = z.read(n).decode('latin-1')
      if 'TShapes' not in text:
        continue
      try:
        surfs, notes = B.brepToSurfaces(text, elem=0)
      except ValueError:
        continue
      torus += sum(1 for s in surfs if s.get('kind') == 7)
      for note in notes:
        cnt[note.split('(')[0].strip()] += 1
  assert torus >= 3, dict(cnt)
  assert cnt.get('tessellated torus', 0) == 0, dict(cnt)
