'''Surface-source device path: the on-device sampler (deviceGenerator /
deviceColumnsGenerator) must match the host-numpy reference sampler
statistically, and surface sources must take the histogram-first fast path in the runner (reference:
freecad_elements/surface_source.py:269-555).'''

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optics_design_workbench.models import Scene, OpticalGroup
from optics_design_workbench.models.surface_source import (
                                                           SurfaceSource, _surfaceSampleColumns)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T


class _Settings:
  def __init__(self, n):
    self.n = n

  def raysPerIteration(self):
    return self.n


def _emitterScene(kinds=('plane', 'sphere', 'cylinder', 'cone', 'asphere')):
  surfs = []
  if 'plane' in kinds:
    surfs.append(S.plane(np.eye(4), elem=0, halfExtents=(10., 5.)))
  if 'sphere' in kinds:
    surfs.append(S.sphere(np.eye(4), elem=0, radius=8., zRange=(2., 8.)))
  if 'cylinder' in kinds:
    surfs.append(S.cylinder(np.eye(4), elem=0, radius=4., zRange=(0., 6.)))
  if 'cone' in kinds:
    surfs.append(S.cone(np.eye(4), elem=0, radius=6., tanAngle=-0.5,
                        zRange=(0., 8.)))
  if 'asphere' in kinds:
    surfs.append(S.asphere(np.eye(4), elem=0, curvature=0.05, conic=-1.,
                           coeffs=(1e-6, 0., 0.), rMax=8.))
  scene = Scene(label='ssdev')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Emitter', surfaces=surfs,
      placements=[T.compose(T.translation(3, -2, 10),
                            T.rotation((0, 1, 0), 15))]))
  src = SurfaceSource(Label='SS', ActiveSurfaces=['Emitter'],
                      PowerDensity='cos(theta)**2')
  scene.addSource(src)
  scene.addSimulationSettings(RaysPerIteration=1e4)
  return scene, src


def test_device_sampler_matches_host_statistics():
  '''Positions, face-choice fractions and theta marginal of the device
  sampler must match the host-numpy sampler within Monte-Carlo error.'''
  _scene, src = _emitterScene()
  assert src.supportsDeviceSampling()
  N = 200_000
  b = src.deviceGenerator()(jax.random.PRNGKey(0), N)
  o = np.asarray(b['origins'])
  d = np.asarray(b['directions'])
  th = np.asarray(b['metadata']['initTheta'])
  fi = np.asarray(b['metadata']['faceIndex'])

  hb = src.generateRays('true', settings=_Settings(N),
                        rng=np.random.default_rng(1))
  ho = np.asarray(hb['origins'])
  hth = np.asarray(hb['metadata']['initTheta'])

  assert np.abs(np.linalg.norm(d, axis=1) - 1).max() < 1e-5
  assert np.allclose(o.mean(0), ho.mean(0), atol=0.08)
  assert np.allclose(o.std(0), ho.std(0), rtol=0.02)
  assert abs(th.mean() - hth.mean()) < 0.01
  assert abs(th.std() - hth.std()) < 0.01
  # face fractions proportional to areas
  faces = src._faceConstants()
  for i, f in enumerate(faces):
    expect = f['cumHi'] - f['cumLo']
    assert abs(float((fi == i).mean()) - expect) < 0.01


def test_device_sampler_stratified_mode():
  '''drawPseudo analog: stratified theta draws keep the same marginal.'''
  _scene, src = _emitterScene(kinds=('plane',))
  N = 50_000
  bT = src.deviceGenerator()(jax.random.PRNGKey(2), N, stratified=True)
  bF = src.deviceGenerator()(jax.random.PRNGKey(3), N, stratified=False)
  tT = np.asarray(bT['metadata']['initTheta'])
  tF = np.asarray(bF['metadata']['initTheta'])
  assert abs(tT.mean() - tF.mean()) < 0.01
  assert abs(tT.std() - tF.std()) < 0.01


def test_surface_source_takes_histogram_fast_path(tmp_path):
  '''runSimulation(recording='histogram') with a surface source must run
  the on-device fast path (device generator, not host generateRays) and
  produce correct detector counts.'''
  from optics_design_workbench.simulation import (runSimulation,
                                                  results_store)

  scene = Scene(label=str(tmp_path / 'ss'))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Emitter',
      surfaces=[S.plane(np.eye(4), elem=0, radius=5.)],
      placements=[T.translation(0, 0, 0)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 40.)]))
  src = SurfaceSource(Label='SS', ActiveSurfaces=['Emitter'],
                      PowerDensity='cos(theta)**2')
  scene.addSource(src)
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3,
                              EndAfterRays=4e4)
  run = runSimulation(scene, 'true', recording='histogram')
  h = results_store.loadHistogramSnapshots(run)
  counts = h['SS']['Det']['counts']
  # emitter plane points +z; a cos^2 lobe from each point hits the
  # detector plane for every draw with theta < ~pi/2
  assert counts.sum() > 3.5e4
  # host raw-sample rows were recorded too (metadata-rich sample path)
  import glob
  hits = glob.glob(os.path.join(run, 'source-SS', 'object-Det', '*-hits.*'))
  assert hits


def test_torus_face_device_host_equivalence():
  '''A torus emitter face (STEP-imported parts now ingest tori
  analytically): the device column sampler must statistically match the
  host numpy sampler — positions on the tube (|g| ~ 0), area-uniform in
  the tube angle, and normals outward.'''
  import numpy as np
  import jax
  from optics_design_workbench.models import (Scene, SurfaceSource,
                                              OpticalGroup)
  from optics_design_workbench.geometry import surfaces as S

  R0, rT = 20., 5.
  scene = Scene(label='torussrc')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Vacuum', Label='Emitter',
      surfaces=[S.torus(np.eye(4), elem=0, majorRadius=R0,
                        minorRadius=rT)],
      placements=[np.eye(4)]))
  src = SurfaceSource(Label='Src', PowerDensity='cos(theta)^2',
                      ActiveSurfaces=['Emitter'], Wavelength=532.)
  scene.addSource(src)
  scene.addSimulationSettings(RaysPerIteration=1e3, MaxIntersections=2)
  scene.compile()

  gen = src.deviceColumnsGenerator()
  cols = gen(jax.random.PRNGKey(3), 4096)
  ox = np.asarray(cols['ox']); oy = np.asarray(cols['oy'])
  oz = np.asarray(cols['oz'])
  s = np.hypot(ox, oy)
  g = (s - R0) ** 2 + oz ** 2 - rT * rT
  assert np.abs(g).max() < 1e-2              # on the tube
  # tube-angle distribution ~ (R + r cos v): outer half carries more area
  v = np.arctan2(oz, s - R0)
  outer = (np.abs(v) < np.pi / 2).mean()
  expect = (R0 * np.pi + 2 * rT) / (2 * np.pi * R0)  # analytic outer share
  assert abs(outer - expect) < 0.03
  # host sampler agrees on the same statistic
  pts, nrm = src._activeFaces()[0].samplePositions(
      4096, np.random.default_rng(5))
  vH = np.arctan2(pts[:, 2], np.hypot(pts[:, 0], pts[:, 1]) - R0)
  assert abs((np.abs(vH) < np.pi / 2).mean() - outer) < 0.04
