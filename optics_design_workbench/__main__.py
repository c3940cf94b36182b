'''
Command-line entry point — the headless analog of the reference's workbench
toolbar/menu commands (reference: init_gui.py:21-47,
freecad_elements/simulation_actions.py):

  python -m optics_design_workbench run <scene> <action>
      actions: fans, singletrue, singlepseudo, true, pseudo, stop, clear
      <scene> is a *.scene.pkl or an FCStd project of the reference
      workbench (ingested without FreeCAD).
  python -m optics_design_workbench info <scene>
  python -m optics_design_workbench export <scene> out.ply [--rays fans]
  python -m optics_design_workbench runs <scene>
  python -m optics_design_workbench bench
  python -m optics_design_workbench dryrun-multichip [n]
'''

import argparse
import json
import sys


def _loadScene(path):
  if path.endswith('.FCStd'):
    from .models import loadFCStd
    return loadFCStd(path)
  from .jupyter_utils import loadScene, Document
  try:
    return loadScene(path if path.endswith('.scene.pkl')
                     else path + '.scene.pkl')
  except FileNotFoundError:
    return Document(path).scene


def main(argv=None):
  parser = argparse.ArgumentParser(prog='optics_design_workbench',
                                   description=__doc__)
  sub = parser.add_subparsers(dest='cmd', required=True)

  runP = sub.add_parser('run', help='run a simulation action on a scene')
  runP.add_argument('scene')
  runP.add_argument('action', choices=['fans', 'singletrue', 'singlepseudo',
                                       'true', 'pseudo', 'stop', 'clear'])
  runP.add_argument('--seed', type=int, default=None)
  runP.add_argument('--store', action='store_true', default=None,
                    help='force storing results for single-shot actions')
  runP.add_argument('--draw', action='store_true',
                    help='collect ray polylines of a single-shot action '
                         'into drawn-rays.ply/.npz in the run folder (the '
                         'headless analog of the GUI ray view)')

  infoP = sub.add_parser('info', help='print the scene inventory')
  infoP.add_argument('scene')

  runsP = sub.add_parser('runs', help='list raw result folders')
  runsP.add_argument('scene')

  expP = sub.add_parser('export', help='tessellate the scene to a colored '
                        'PLY mesh, optionally with traced rays')
  expP.add_argument('scene')
  expP.add_argument('out', help='output .ply path')
  expP.add_argument('--resolution', type=int, default=48)
  expP.add_argument('--rays', choices=['fans', 'singletrue', 'singlepseudo'],
                    default=None,
                    help='also run this single-shot action and include the '
                         'drawn ray polylines')
  expP.add_argument('--seed', type=int, default=None)

  sub.add_parser('bench', help='run the headline benchmark')

  dryP = sub.add_parser('dryrun-multichip', help='multi-chip compile check')
  dryP.add_argument('n', type=int, nargs='?', default=8)

  args = parser.parse_args(argv)

  if args.cmd == 'run':
    from . import simulation
    scene = _loadScene(args.scene)
    runPath = simulation.runSimulation(scene, args.action, seed=args.seed,
                                       store=args.store, draw=args.draw)
    if runPath:
      print(runPath)
    return 0

  if args.cmd == 'export':
    from .geometry.tessellate import writeScenePLY
    scene = _loadScene(args.scene)
    drawn = None
    if args.rays:
      from . import simulation
      from .simulation.draw import DrawnRays
      drawn = DrawnRays()
      simulation.runSimulation(scene, args.rays, seed=args.seed,
                               draw=drawn, store=False)
    print(writeScenePLY(scene, args.out, resolution=args.resolution,
                        drawnRays=drawn))
    return 0

  if args.cmd == 'info':
    scene = _loadScene(args.scene)
    info = scene.collectGlobalInfo()

    def describeGroup(label):
      from .geometry.surfaces import _KIND_NAMES
      for g in scene.opticalObjects():
        if g.Label == label:
          kinds = {}
          for s in g.surfaces:
            name = _KIND_NAMES.get(s['kind'], str(s['kind']))
            kinds[name] = kinds.get(name, 0) + 1
          return ' + '.join(f'{n} {k}' for k, n in sorted(kinds.items()))
      return ''

    print(json.dumps(dict(
        label=info['label'],
        sources={k: v.get('PowerDensity') for k, v in
                 info['sources'].items()},
        opticalObjects={k: f"{v.get('OpticalType')} ({describeGroup(k)})"
                        for k, v in info['opticalObjects'].items()},
        settings=list(info['settings'])), indent=2))
    return 0

  if args.cmd == 'runs':
    from . import simulation
    from .jupyter_utils import rawFolders
    scene = _loadScene(args.scene)
    folder = simulation.getResultsFolderPath(scene.path or scene.label,
                                             ensure=False)
    for raw in rawFolders(folder):
      prog = raw.progress()
      extra = ''
      if prog:
        extra = (f"  rays={prog.get('totalTracedRays', 0):g} "
                 f"hits={prog.get('totalRecordedHits', 0):g}")
      print(raw.path + extra)
    return 0

  if args.cmd == 'bench':
    import runpy
    import os
    benchPath = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'bench.py')
    runpy.run_path(benchPath, run_name='__main__')
    return 0

  if args.cmd == 'dryrun-multichip':
    import importlib.util
    import os
    entry = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), '__graft_entry__.py')
    spec = importlib.util.spec_from_file_location('graft_entry', entry)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(args.n)
    return 0

  return 1


if __name__ == '__main__':
  sys.exit(main())
