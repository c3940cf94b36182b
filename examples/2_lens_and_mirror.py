'''
Example 2 — spherical lens + fold mirror + detector with hit recording
(reference: examples/2-lens-and-mirror/main.FCStd). The same scene doubles
as the headline benchmark (bench.py).
'''

import numpy as np

from optics_design_workbench import benchmarks, simulation
from optics_design_workbench.jupyter_utils import Document


def main():
  scene = benchmarks.buildLensMirrorScene(tmpdir='.')
  scene.getObject('SimulationSettings').EndAfterRays = '2e5'
  scene.getObject('SimulationSettings').RaysPerIteration = 50000
  doc = Document(scene=scene)
  raw = doc.runSimulation('true', seed=7)
  hits = raw.loadHits('Detector')
  print(f'{len(hits)} hits on the folded detector in {raw.path}')
  normal, xvec = hits.detectPlaneNormal()
  print(f'auto-detected detector plane normal: {np.round(normal, 3)}')
  h = hits.histogram(bins=101)
  print(f'histogram peak density: {h.density.max():.1f} hits/mm^2')


if __name__ == '__main__':
  main()
