'''
Example 5 — headless visualization: trace a single-shot run with ray
drawing, export the tessellated scene + colored ray polylines to one PLY
(openable in MeshLab / Blender), and render a matplotlib preview. This is
the headless analog of the reference GUI's 3D view (drawn RaySegment
objects, generic_source.py:86-140, over the OCC-tessellated shapes).
'''

from optics_design_workbench import benchmarks, simulation
from optics_design_workbench.geometry.tessellate import writeScenePLY
from optics_design_workbench.simulation.draw import DrawnRays


def main():
  scene = benchmarks.buildLensMirrorScene(tmpdir='.')
  scene.getObject('SimulationSettings').RaysPerIteration = 300

  # color the ray view: rays start red, turn teal after the fold mirror
  for group in scene.opticalObjects():
    if group.OpticalType == 'Mirror':
      group.ViewColor, group.ViewColorWeight = (0., 0.8, 0.8), 0.8

  drawn = DrawnRays()
  simulation.runSimulation(scene, 'singletrue', draw=drawn, seed=1,
                           store=False)
  print(f'traced {drawn.rayCount} rays / {drawn.segmentCount} segments')

  out = writeScenePLY(scene, 'lens-mirror-scene.ply', resolution=48,
                      drawnRays=drawn)
  print(f'scene + rays exported to {out}')

  try:
    import matplotlib
    matplotlib.use('Agg')
    ax = drawn.plot(plane='yz', maxRays=150)
    ax.figure.savefig('lens-mirror-rays.png', dpi=130,
                      bbox_inches='tight')
    print('matplotlib preview saved to lens-mirror-rays.png')
  except ImportError:
    print('matplotlib not available; skipped the preview render')


if __name__ == '__main__':
  main()
