'''
Example 1 — Gaussian point source onto an absorbing detector
(reference: examples/1-source-and-detector/main.FCStd + visualize.ipynb).

Runs a Monte-Carlo simulation and a deterministic ray-fan render, then
histograms the detector spot.
'''

import numpy as np

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation
from optics_design_workbench.jupyter_utils import Document


def buildScene(path='example1'):
  scene = Scene(label='example1', path=path)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', Wavelength=532.,
      Fans=2, RaysPerFan=21))
  scene.addSimulationSettings(
      EndAfterRays='2e5', RaysPerIteration=50000, MaxIntersections=4,
      EnableStoreSingleShotData=True,
      StoreHitFanIndex=True, StoreHitRayIndex=True,
      StoreHitTotalRaysInFan=True, StoreHitTotalFanCount=True)
  return scene


def main():
  scene = buildScene()
  doc = Document(scene=scene)

  print('Monte-Carlo run...')
  raw = doc.runSimulation('true', seed=42)
  hits = raw.loadHits('Detector')
  print(f'{len(hits)} hits recorded in {raw.path}')
  r = np.hypot(hits.points()[:, 0], hits.points()[:, 1])
  print(f'spot rms radius: {np.sqrt((r**2).mean()):.2f} mm '
        f'(theory ~ {100*np.tan(0.1):.2f}+ mm)')

  print('ray-fan render...')
  rawFan = doc.runSimulation('fans')
  fanHits = rawFan.loadHits('Detector')
  dens = fanHits.fanEstimatedPowerDensities()
  print(f'fan mode: {fanHits.fanCount()} fans, reconstructed power-density '
        f'profiles for fans {sorted(dens)}')

  try:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    hits.histogram(bins=101).plot()
    plt.savefig('example1-spot.png', dpi=120)
    print('wrote example1-spot.png')
  except Exception as e:
    print(f'(plotting skipped: {e})')


if __name__ == '__main__':
  main()
