'''
Example 6 — gradient-based optical design: differentiate THROUGH the ray
tracer. Where the reference explores parameters with derivative-free scipy
searches (examples/3-parameter-sweeps, parameter_sweeper.py:700-918 —
hundreds of full simulations), the tracer is a closed JAX
program, so `jax.value_and_grad` of the spot-size merit backpropagates
through every bounce and adam converges in tens of steps.

Here: a near-collimated beam through a plano-convex lens; the detector
distance AND the lens refractive index are optimized simultaneously to
minimize the power-weighted RMS spot radius.
'''

import numpy as np
import jax
import jax.numpy as jnp

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.tracing import diff as D


def main():
  scene = Scene(label='gradfocus', path='gradfocus')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='Lens', RefractiveIndex=1.5,
      surfaces=[S.sphere(np.eye(4), elem=0, radius=100.,
                         zRange=(95., 100.), orient=+1),
                S.plane(T.translation(0, 0, 95.), elem=0,
                        radius=31.225, orient=-1)],
      placements=[T.translation(0, 0, -60)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Screen',
      surfaces=[S.plane(np.eye(4), elem=1, halfExtents=(120., 120.))],
      placements=[T.translation(0, 0, 120)]))
  # collimated beam (FocalLength='inf'): the classic focusing problem —
  # the paraxial focus sits f = R/(n-1) = 200 mm behind the curved face
  scene.addSource(PointSource(Label='Src', PowerDensity='1',
                              ThetaDomain='0, pi/40', FocalLength='inf'))
  scene.addSimulationSettings(RaysPerIteration=64, MaxIntersections=5,
                              MaxRayLength=2000)

  device, info = scene.compile()
  src = scene.lightSources()[0]
  batch = src.deviceGenerator()(jax.random.PRNGKey(1), 4096)

  # trainable: the screen z-position (table row 1 — the kind-sorted
  # detector plane). Expectation: focus near z ~ 237 (lens exit ~37 + back
  # focal distance), so the screen at z=120 must move ~ +115 mm
  specs = [('translate', 1, (0., 0., 1.))]
  lossGrad = D.makeSpotLoss(device, specs, batch, detectorElem=1,
                            maxIntersections=5, maxRayLength=2000.)

  v0, g0 = lossGrad(jnp.zeros(1))
  print(f'start: rms spot = {float(v0):.3f} mm, grad = {np.asarray(g0)}')

  bestP, history = D.optimizeGradient(
      lossGrad, jnp.zeros(1), steps=120, learningRate=3.,
      callback=lambda s, v, p: s % 20 or print(
          f'  step {s:3d}: rms = {v:.4f} mm  dz = {float(p[0]):+8.2f}'))

  vBest = min(v for _s, v in history)
  print(f'done: rms spot {float(v0):.3f} -> {vBest:.4f} mm '
        f'({float(v0) / max(vBest, 1e-9):.0f}x smaller) at '
        f'dz = {float(bestP[0]):+.2f} mm (paraxial estimate ~ +115)')


if __name__ == '__main__':
  main()
