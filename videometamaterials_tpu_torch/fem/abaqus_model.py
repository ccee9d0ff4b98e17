# -*- coding: utf-8 -*-
"""Abaqus CAE model builder + ODB post-processing (runs INSIDE Abaqus python).

Functional re-design of the reference abaqus/abaqus_script.py (1407 lines):
pixel geometry -> 2-fold mirrored periodic CAD part -> J2-plasticity material
(Jin et al., PNAS 2019 parameters) -> plane-strain mesh -> analytic rigid
compression plates -> implicit-dynamics step with smooth-step amplitude to 20%
compression -> self/plate contact (friction 0.4) -> lateral periodic BC node
equations -> job -> ODB extraction:

  csv/stress_strain.csv        51-point strain/stress curve (sum of RF2 over
                               top nodes, sign-flipped; 52 history time points
                               with the last dropped)
  csv/solver_flags.csv         [energy warning, periodic-bc-pairing warning]
  csv/geometry.csv             the evaluated input geometry (flattened)
  csv/*_frames_{eul,lagr}.csv  11-frame field videos on the 96x96 pixel grid
                               (store_frames only)

Where the reference samples fields via repeated session.XYDataFromPath calls
(a fragile workaround, abaqus_script.py:814-860), this version reads fields
directly from the ODB (element centroids + nodal displacements) and
rasterizes onto the pixel grid with numpy -- same outputs, no path hacks.

Must stay Python-2 compatible (Abaqus CAE 2020 ships py2.7). Cannot run
outside Abaqus; exercised indirectly through fem/eval_abaqus.py whose CSV
conversion IS tested.

The port's copy of videometamaterials_tpu/fem/abaqus_model.py.
"""

from __future__ import print_function

import argparse
import os

import numpy as np

# Abaqus imports only resolve inside `abaqus cae noGUI=...`
from part import *           # noqa: F401,F403
from material import *       # noqa: F401,F403
from section import *        # noqa: F401,F403
from assembly import *       # noqa: F401,F403
from step import *           # noqa: F401,F403
from interaction import *    # noqa: F401,F403
from load import *           # noqa: F401,F403
from mesh import *           # noqa: F401,F403
from job import *            # noqa: F401,F403
from sketch import *         # noqa: F401,F403
from odbAccess import *      # noqa: F401,F403

# ------------------------------------------------------------------ arguments

parser = argparse.ArgumentParser()
parser.add_argument('--samples_path', type=str, required=True)
parser.add_argument('--sample_index', type=int, required=True)
parser.add_argument('--store_frames', type=str, required=False, default='')
parser.add_argument('--pixels', type=int, required=False, default=48)
parser.add_argument('--strain', type=float, required=False, default=-0.2)
parser.add_argument('--numEvalIntervals', type=int, required=False, default=50)
parser.add_argument('--bounding_box', type=str, required=False, default='')
parser.add_argument('--radius', type=float, required=False, default=0.)
parser.add_argument('--density', type=float, required=False, default=1.e-8)
parser.add_argument('--coarseness', type=float, required=False, default=0.015)
# the reference keeps these as in-file toggles (abaqus_script.py:49-59);
# exposed here as flags with the reference defaults
parser.add_argument('--solver', type=str, required=False, default='implicit',
                    choices=('implicit', 'static', 'explicit'))
parser.add_argument('--material', type=str, required=False,
                    default='Jin_et_al',
                    choices=('Jin_et_al', 'neo_hooke'))
parser.add_argument('--y_periodicity', type=str, required=False, default='')
parser.add_argument('--splined', type=str, required=False, default='True')
args, _unknown = parser.parse_known_args()


def _flag(s):
    return s in ('True', 'true', '1')


samples_path = args.samples_path
sample_index = args.sample_index
store_frames = _flag(args.store_frames)
pixels = args.pixels
strain = args.strain
numEvalIntervals = args.numEvalIntervals
density = args.density
coarseness = args.coarseness
solver = args.solver
material = args.material
y_periodicity = _flag(args.y_periodicity)
bounding_box = _flag(args.bounding_box)
splined = _flag(args.splined)

strain_spacing = np.linspace(0., np.abs(strain), numEvalIntervals + 1)

MODEL, PART, MATERIAL, JOB = 'Model-1', 'Part-1', 'Material-1', 'Job-1'

save_path = os.path.join(samples_path,
                         'abaqus_eval_sample_%d' % sample_index, 'csv')
if not os.path.isdir(save_path):
    os.makedirs(save_path)

m = mdb.models[MODEL]  # noqa: F821

# 11 field frames / 52 history points in smooth-step pseudo-time; first frame
# at 1% strain, consistent with the training label convention
# (abaqus_script.py:577-591). Imported below (after sys.path setup) from
# fem/timepoints.py, which the stub-execution test harness shares.

# J2 plasticity of Jin et al. (doi:10.1073/pnas.1913228117);
# abaqus_script.py:330-354
JIN_PLASTIC_TABLE = (
    (40.62, 0.0), (45.24, 0.001133), (52.62, 0.004183), (58.00, 0.0080645),
    (61.87, 0.012557), (65.81, 0.020035), (69.19, 0.030689),
    (71.06, 0.038873), (72.61, 0.047114), (73.54, 0.052610),
    (74.82, 0.06083), (76.74, 0.074477), (78.46, 0.08799), (81.58, 0.11457),
    (83.00, 0.1276))


# ---------------------------------------------------------- geometry import
# The geometry math (loop tracing, corner reduction, spline anchoring,
# radius corner-rounding) lives in the pure-numpy, unit-tested module
# fem/part_geometry.py; this script just replays the sketch plan.
import sys  # noqa: E402

try:
    _here = os.path.dirname(os.path.abspath(__file__))
except NameError:              # some Abaqus builds exec without __file__
    _here = os.getcwd()
sys.path.insert(0, os.path.dirname(os.path.dirname(_here)))
from videometamaterials_tpu_torch.fem.part_geometry import (  # noqa: E402
    apply_bounding_box,
    mirror_periodic,
    sketch_plan,
)
from videometamaterials_tpu_torch.fem.timepoints import (  # noqa: E402
    FIELD_TIME_POINTS,
    HISTORY_TIME_POINTS,
)

# -------------------------------------------------------------------- build

geometries = np.genfromtxt(os.path.join(samples_path, 'geometries.csv'),
                           delimiter=',').reshape(-1, pixels, pixels)
selected_geometry = geometries[sample_index]

if bounding_box:               # abaqus_script.py:296-300
    selected_geometry = apply_bounding_box(selected_geometry)

geom = mirror_periodic(selected_geometry)
cad_pixels = 2 * pixels

plan = sketch_plan(geom, splined=splined, radius=args.radius)

sketch = m.ConstrainedSketch(name='__cell__', sheetSize=4.0)
for seg in plan['segments']:
    if seg[0] == 'line':
        sketch.Line(point1=tuple(seg[1]), point2=tuple(seg[2]))
    elif seg[0] == 'spline':
        sketch.Spline(points=[tuple(p) for p in seg[1]])
    else:                       # ('arc', center, clockwise, p1, p2)
        sketch.ArcByCenterEnds(
            center=tuple(seg[1]),
            direction=CLOCKWISE if seg[2] else COUNTERCLOCKWISE,  # noqa: F821
            point1=tuple(seg[3]), point2=tuple(seg[4]))
part = m.Part(dimensionality=TWO_D_PLANAR, name=PART,      # noqa: F821
              type=DEFORMABLE_BODY)                          # noqa: F821
part.BaseShell(sketch=sketch)
del m.sketches['__cell__']

interior_pt = (plan['interior_point'][0], plan['interior_point'][1], 0.0)
for idx, probes in enumerate(plan['surf_probes']):
    pts = tuple(((p[0], p[1], 0.0),) for p in probes)
    part.Surface(name='Surf_%d' % idx, side1Edges=part.edges.findAt(*pts))
num_surf = len(plan['surf_probes'])
if plan['outer_probes']:       # abaqus_script.py:325-327
    pts = tuple(((p[0], p[1], 0.0),) for p in plan['outer_probes'])
    part.Surface(name='Surf_outer', side1Edges=part.edges.findAt(*pts))

# material + section (abaqus_script.py:330-372)
m.Material(name=MATERIAL)
if material == 'Jin_et_al':
    m.materials[MATERIAL].Elastic(table=((2.306e3, 0.35),))
    m.materials[MATERIAL].Density(table=((density,),))
    m.materials[MATERIAL].Damping(beta=0.005)
    m.materials[MATERIAL].Plastic(table=JIN_PLASTIC_TABLE)
else:                           # neo-Hookean (abaqus_script.py:356-360)
    m.materials[MATERIAL].Density(table=((density,),))
    m.materials[MATERIAL].Hyperelastic(
        materialType=ISOTROPIC,                              # noqa: F821
        table=((0.192311, 0.288461),), testData=OFF,         # noqa: F821
        type=NEO_HOOKE, volumetricResponse=VOLUMETRIC_DATA)  # noqa: F821
m.HomogeneousSolidSection(material=MATERIAL, name='Section-1', thickness=None)
part.Set(faces=part.faces.findAt((interior_pt,)), name='FullSet')
part.SectionAssignment(offset=0.0, offsetField='',
                       offsetType=MIDDLE_SURFACE,             # noqa: F821
                       region=part.sets['FullSet'], sectionName='Section-1',
                       thicknessAssignment=FROM_SECTION)      # noqa: F821

# mesh: plane strain, CPE4 for static / CPE4R otherwise
# (abaqus_script.py:374-391)
part.seedPart(deviationFactor=0.1, minSizeFactor=0.1, size=coarseness)
part.generateMesh()
quad_code = CPE4 if solver == 'static' else CPE4R               # noqa: F821
part.setElementType(
    elemTypes=(ElemType(elemCode=quad_code, elemLibrary=STANDARD,  # noqa: F821
                        secondOrderAccuracy=OFF,                # noqa: F821
                        hourglassControl=DEFAULT,               # noqa: F821
                        distortionControl=DEFAULT),             # noqa: F821
               ElemType(elemCode=CPE3, elemLibrary=STANDARD)),  # noqa: F821
    regions=(part.faces.findAt((interior_pt,)),))


def make_rigid_line(name, y):
    sk = m.ConstrainedSketch(name='__profile__', sheetSize=4.0)
    sk.Line(point1=(-1.0, y), point2=(2.0, y))
    p = m.Part(dimensionality=TWO_D_PLANAR, name=name,
               type=ANALYTIC_RIGID_SURFACE)                    # noqa: F821
    p.AnalyticRigidSurf2DPlanar(sketch=sk)
    del m.sketches['__profile__']
    p.ReferencePoint(point=p.InterestingPoint(
        p.edges.findAt((-0.25, y, 0.0)), MIDDLE))              # noqa: F821
    return p


top_line = make_rigid_line('TopLine', 1.0)
top_line.Surface(name='TopSurf',
                 side2Edges=top_line.edges.findAt(((-0.25, 1.0, 0.0),)))
bot_line = make_rigid_line('BotLine', 0.0)
bot_line.Surface(name='BotSurf',
                 side1Edges=bot_line.edges.findAt(((-0.25, 0.0, 0.0),)))

ra = m.rootAssembly
ra.DatumCsysByDefault(CARTESIAN)                               # noqa: F821
ra.Instance(dependent=ON, name='BotLine-1', part=bot_line)     # noqa: F821
ra.Instance(dependent=ON, name='TopLine-1', part=top_line)     # noqa: F821
ra.Instance(dependent=ON, name='Part-1-1', part=part)          # noqa: F821

# node sets (abaqus_script.py:440-470)
allNodes = ra.instances['Part-1-1'].nodes
bot_nodes, top_nodes = [], []
for node in allNodes:
    if np.isclose(node.coordinates[1], 0.):
        bot_nodes.append(node.label - 1)
    if np.isclose(node.coordinates[1], 1.):
        top_nodes.append(node.label - 1)
ra.Set(name='BotNodesSet',
       nodes=[allNodes[i:i + 1] for i in bot_nodes])
ra.Set(name='TopNodesSet',
       nodes=[allNodes[i:i + 1] for i in top_nodes])
ra.Set(name='TopLineSet',
       referencePoints=(ra.instances['TopLine-1'].referencePoints[2],))
ra.Set(name='BotLineSet',
       referencePoints=(ra.instances['BotLine-1'].referencePoints[2],))

# solver step (abaqus_script.py:479-504)
if solver == 'explicit':
    m.ExplicitDynamicsStep(improvedDtMethod=ON, name='Step-1',   # noqa: F821
                           previous='Initial')
elif solver == 'static':
    m.StaticStep(name='Step-1', nlgeom=ON, previous='Initial')   # noqa: F821
    m.AdaptiveMeshControl(name='Ada-1')   # ALE remeshing (abaqus_script:499)
    m.steps['Step-1'].AdaptiveMeshDomain(
        controls='Ada-1', region=ra.instances['Part-1-1'].sets['FullSet'],
        frequency=5, meshSweeps=3)
else:
    m.ImplicitDynamicsStep(name='Step-1', previous='Initial',
                           timePeriod=1.0,
                           nlgeom=ON, initialInc=1e-3, minInc=1e-8,  # noqa: F821
                           maxNumInc=400, alpha=DEFAULT,             # noqa: F821
                           amplitude=RAMP,                           # noqa: F821
                           application=MODERATE_DISSIPATION,         # noqa: F821
                           initialConditions=OFF)                    # noqa: F821

# contact (abaqus_script.py:506-567)
m.ContactProperty('IntProp-1')
m.interactionProperties['IntProp-1'].TangentialBehavior(
    dependencies=0, directionality=ISOTROPIC,                   # noqa: F821
    elasticSlipStiffness=None, formulation=PENALTY,             # noqa: F821
    fraction=0.005, maximumElasticSlip=FRACTION,                # noqa: F821
    pressureDependency=OFF, shearStressLimit=None,              # noqa: F821
    slipRateDependency=OFF, table=((0.4,),),                    # noqa: F821
    temperatureDependency=OFF)                                  # noqa: F821
m.interactionProperties['IntProp-1'].NormalBehavior(
    allowSeparation=ON, constraintEnforcementMethod=DEFAULT,    # noqa: F821
    pressureOverclosure=HARD)                                   # noqa: F821
m.ContactProperty('SlipContact')
m.interactionProperties['SlipContact'].NormalBehavior(
    allowSeparation=ON, constraintEnforcementMethod=DEFAULT,    # noqa: F821
    pressureOverclosure=HARD)                                   # noqa: F821

# explicit vs standard contact (abaqus_script.py:521-567); the plate
# contacts exist only when nodes are not tied periodically in y
if solver == 'explicit':
    for idx in range(num_surf):
        m.SelfContactExp(createStepName='Step-1',
                         interactionProperty='IntProp-1',
                         mechanicalConstraint=KINEMATIC,        # noqa: F821
                         name='Int-1-%d' % (idx + 1),
                         surface=ra.instances['Part-1-1'].surfaces
                         ['Surf_%d' % idx])
    if not y_periodicity:
        for name, inst, surf in (('TopContact', 'TopLine-1', 'TopSurf'),
                                 ('BotContact', 'BotLine-1', 'BotSurf')):
            m.SurfaceToSurfaceContactExp(
                clearanceRegion=None, createStepName='Step-1',
                datumAxis=None, initialClearance=OMIT,          # noqa: F821
                interactionProperty='SlipContact',
                master=ra.instances[inst].surfaces[surf], name=name,
                slave=ra.instances['Part-1-1'].surfaces['Surf_0'],
                sliding=FINITE)                                 # noqa: F821
else:
    for idx in range(num_surf):
        m.SelfContactStd(createStepName='Step-1',
                         interactionProperty='IntProp-1',
                         name='Int-1-%d' % (idx + 1),
                         surface=ra.instances['Part-1-1'].surfaces
                         ['Surf_%d' % idx], thickness=ON)       # noqa: F821
    if not y_periodicity:
        for name, inst, surf in (('TopContact', 'TopLine-1', 'TopSurf'),
                                 ('BotContact', 'BotLine-1', 'BotSurf')):
            m.SurfaceToSurfaceContactStd(
                adjustMethod=NONE, clearanceRegion=None,        # noqa: F821
                createStepName='Step-1', datumAxis=None,
                initialClearance=OMIT,                          # noqa: F821
                interactionProperty='SlipContact',
                master=ra.instances[inst].surfaces[surf], name=name,
                slave=ra.instances['Part-1-1'].surfaces['Surf_0'],
                sliding=FINITE, thickness=ON)                   # noqa: F821

# outputs: one extra strain step sampled to mitigate inertia
# (abaqus_script.py:571-573)
strain += strain / numEvalIntervals
numEvalIntervals += 1

m.TimePoint(name='TimePoints-1', points=FIELD_TIME_POINTS)
m.TimePoint(name='TimePoints-2', points=HISTORY_TIME_POINTS)
m.fieldOutputRequests['F-Output-1'].setValues(
    timePoint='TimePoints-1',
    variables=('S', 'PE', 'PEEQ', 'PEMAG', 'LE', 'U', 'RF', 'CSTRESS',
               'CDISP', 'ENER', 'ELEN', 'ELEDEN', 'SENER', 'COORD'))
del m.historyOutputRequests['H-Output-1']
m.HistoryOutputRequest(createStepName='Step-1', name='H-Output-0',
                       rebar=EXCLUDE,                           # noqa: F821
                       region=ra.sets['TopNodesSet'],
                       sectionPoints=DEFAULT,                   # noqa: F821
                       variables=('U2', 'RF2'), timePoint='TimePoints-2')
m.HistoryOutputRequest(createStepName='Step-1', name='H-Output-1',
                       rebar=EXCLUDE,                           # noqa: F821
                       region=ra.sets['TopLineSet'],
                       sectionPoints=DEFAULT,                   # noqa: F821
                       variables=('U2', 'RF2'), timePoint='TimePoints-2')
# explicit has no static-dissipation energy (abaqus_script.py:615-622)
_energy_vars = (('ALLAE', 'ALLKE', 'ALLIE', 'ETOTAL') if solver == 'explicit'
                else ('ALLAE', 'ALLSD', 'ALLKE', 'ALLIE', 'ETOTAL'))
m.HistoryOutputRequest(createStepName='Step-1', name='H-Output-2',
                       timePoint='TimePoints-2', variables=_energy_vars)

m.SmoothStepAmplitude(data=((0.0, 0.0), (1.0, 1.0)), name='Amp-1',
                      timeSpan=STEP)                            # noqa: F821

# boundary conditions (abaqus_script.py:655-690)
m.DisplacementBC(amplitude=UNSET, createStepName='Initial',     # noqa: F821
                 distributionType=UNIFORM, fieldName='',        # noqa: F821
                 localCsys=None, name='BC-1',
                 region=ra.sets['BotLineSet'], u1=SET, u2=SET,  # noqa: F821
                 ur3=SET)                                       # noqa: F821
m.DisplacementBC(amplitude=UNSET, createStepName='Initial',     # noqa: F821
                 distributionType=UNIFORM, fieldName='',        # noqa: F821
                 localCsys=None, name='BC-2',
                 region=ra.sets['TopLineSet'], u1=SET,          # noqa: F821
                 u2=UNSET, ur3=SET)                             # noqa: F821
m.DisplacementBC(amplitude='Amp-1', createStepName='Step-1',
                 distributionType=UNIFORM, fieldName='',        # noqa: F821
                 fixed=OFF, localCsys=None, name='BC-3',        # noqa: F821
                 region=ra.sets['TopLineSet'], u1=UNSET,        # noqa: F821
                 u2=strain, ur3=UNSET)                          # noqa: F821
if not y_periodicity:
    # 'attach' top/bottom nodes to the plates (abaqus_script.py:675-690)
    m.DisplacementBC(amplitude=UNSET, createStepName='Initial',  # noqa: F821
                     distributionType=UNIFORM, fieldName='',     # noqa: F821
                     localCsys=None, name='BC-4',
                     region=ra.sets['BotNodesSet'], u1=SET,      # noqa: F821
                     u2=SET, ur3=UNSET)                          # noqa: F821
    m.DisplacementBC(amplitude=UNSET, createStepName='Initial',  # noqa: F821
                     distributionType=UNIFORM, fieldName='',     # noqa: F821
                     localCsys=None, name='BC-5',
                     region=ra.sets['TopNodesSet'], u1=SET,      # noqa: F821
                     u2=UNSET, ur3=UNSET)                        # noqa: F821
    m.DisplacementBC(amplitude='Amp-1', createStepName='Step-1',
                     distributionType=UNIFORM, fieldName='',     # noqa: F821
                     fixed=OFF, localCsys=None, name='BC-6',     # noqa: F821
                     region=ra.sets['TopNodesSet'], u1=UNSET,    # noqa: F821
                     u2=strain, ur3=UNSET)                       # noqa: F821
    flag_RBM_x = True
    flag_RBM_y = True
else:
    # periodic y ties replace the node-plate attachment; rigid-body modes
    # get pinned on the first node pairs (abaqus_script.py:631-653,700-715)
    flag_RBM_x = False
    flag_RBM_y = False

# periodic BCs via node-pair equations (abaqus_script.py:692-751)
periodic_bc_flag = False
delta = 1.e-3
for idx, node in enumerate(allNodes):
    x, y = node.coordinates[0], node.coordinates[1]
    if np.isclose(x, 0.) and not np.isclose(y, 0.) and not np.isclose(y, 1.):
        left = allNodes.getByBoundingBox(-delta, y - delta, -delta,
                                         delta, y + delta, delta)
        right = allNodes.getByBoundingBox(1. - delta, y - delta, -delta,
                                          1. + delta, y + delta, delta)
        if not right:
            periodic_bc_flag = True
            continue
        ra.Set(name='BC_lr_%dA' % idx, nodes=left)
        ra.Set(name='BC_lr_%dB' % idx, nodes=right)
        if not flag_RBM_x:
            # no plate attachment: pin the first pair in x instead of
            # equating it (kills the x rigid-body mode)
            m.DisplacementBC(amplitude=UNSET,                    # noqa: F821
                             createStepName='Initial',
                             distributionType=UNIFORM,           # noqa: F821
                             fieldName='', localCsys=None, name='RBM_X_A',
                             region=ra.sets['BC_lr_%dA' % idx],
                             u1=SET, u2=UNSET, ur3=UNSET)        # noqa: F821
            m.DisplacementBC(amplitude=UNSET,                    # noqa: F821
                             createStepName='Initial',
                             distributionType=UNIFORM,           # noqa: F821
                             fieldName='', localCsys=None, name='RBM_X_B',
                             region=ra.sets['BC_lr_%dB' % idx],
                             u1=SET, u2=UNSET, ur3=UNSET)        # noqa: F821
            m.Equation(name='Constraint-%d_lr_y' % idx,
                       terms=((1.0, 'BC_lr_%dA' % idx, 2),
                              (-1.0, 'BC_lr_%dB' % idx, 2)))
            flag_RBM_x = True
        else:
            m.Equation(name='Constraint-%d_lr_x' % idx,
                       terms=((1.0, 'BC_lr_%dA' % idx, 1),
                              (-1.0, 'BC_lr_%dB' % idx, 1)))
            m.Equation(name='Constraint-%d_lr_y' % idx,
                       terms=((1.0, 'BC_lr_%dA' % idx, 2),
                              (-1.0, 'BC_lr_%dB' % idx, 2)))
    elif y_periodicity and np.isclose(y, 0.) and \
            not np.isclose(x, 0.) and not np.isclose(x, 1.):
        bottom = allNodes.getByBoundingBox(x - delta, -delta, -delta,
                                           x + delta, delta, delta)
        top = allNodes.getByBoundingBox(x - delta, 1. - delta, -delta,
                                        x + delta, 1. + delta, delta)
        if not top:
            periodic_bc_flag = True
            continue
        ra.Set(name='BC_ud_%dA' % idx, nodes=bottom)
        ra.Set(name='BC_ud_%dB' % idx, nodes=top)
        if not flag_RBM_y:
            # pin the first pair in y: bottom fixed, top follows the strain
            # amplitude (abaqus_script.py:731-744)
            m.DisplacementBC(amplitude=UNSET,                    # noqa: F821
                             createStepName='Initial',
                             distributionType=UNIFORM,           # noqa: F821
                             fieldName='', localCsys=None, name='RBM_Y_A',
                             region=ra.sets['BC_ud_%dA' % idx],
                             u1=UNSET, u2=SET, ur3=UNSET)        # noqa: F821
            m.DisplacementBC(amplitude='Amp-1', createStepName='Step-1',
                             distributionType=UNIFORM,           # noqa: F821
                             fieldName='', fixed=OFF,            # noqa: F821
                             localCsys=None, name='RBM_Y_B',
                             region=ra.sets['BC_ud_%dB' % idx],
                             u1=UNSET, u2=strain, ur3=UNSET)     # noqa: F821
            m.Equation(name='Constraint-%d_ud_x' % idx,
                       terms=((1.0, 'BC_ud_%dA' % idx, 1),
                              (-1.0, 'BC_ud_%dB' % idx, 1)))
            flag_RBM_y = True
        else:
            m.Equation(name='Constraint-%d_ud_x' % idx,
                       terms=((1.0, 'BC_ud_%dA' % idx, 1),
                              (-1.0, 'BC_ud_%dB' % idx, 1)))
            # u2 pairs couple through the moving top line
            # (abaqus_script.py:748-751)
            m.Equation(name='Constraint-%d_ud_y' % idx,
                       terms=((1.0, 'BC_ud_%dA' % idx, 2),
                              (-1.0, 'BC_ud_%dB' % idx, 2),
                              (1.0, 'TopLineSet', 2)))

# job (abaqus_script.py:753-766)
mdb.Job(atTime=None, contactPrint=OFF, description='',          # noqa: F821
        echoPrint=OFF, explicitPrecision=SINGLE,                # noqa: F821
        historyPrint=OFF, memory=90,                            # noqa: F821
        memoryUnits=PERCENTAGE, model=MODEL, modelPrint=OFF,    # noqa: F821
        multiprocessingMode=DEFAULT, name=JOB,                  # noqa: F821
        nodalOutputPrecision=SINGLE, numCpus=1, numDomains=1,   # noqa: F821
        queue=None, resultsFormat=ODB, scratch='',              # noqa: F821
        type=ANALYSIS, userSubroutine='', waitHours=0,          # noqa: F821
        waitMinutes=0)                                          # noqa: F821
mdb.jobs[JOB].submit(consistencyChecking=OFF)                   # noqa: F821
mdb.jobs[JOB].waitForCompletion()                               # noqa: F821

# ------------------------------------------------------------- ODB extraction

odb = openOdb(JOB + '.odb')                                     # noqa: F821
step = odb.steps['Step-1']

values = np.zeros(numEvalIntervals + 1)
max_ae = max_sd = max_ke = 0.
warning_flag = False
for key in step.historyRegions.keys():
    region = step.historyRegions[key]
    if key == 'Assembly ASSEMBLY':
        data_ae = np.array(region.historyOutputs['ALLAE'].data)
        if len(data_ae.shape) > 0:
            e_ae = data_ae[:, 1]
            # explicit steps record no static-dissipation energy
            if 'ALLSD' in region.historyOutputs.keys():
                e_sd = np.array(region.historyOutputs['ALLSD'].data)[:, 1]
            else:
                e_sd = np.zeros_like(e_ae)
            e_ke = np.array(region.historyOutputs['ALLKE'].data)[:, 1]
            e_ie = np.array(region.historyOutputs['ALLIE'].data)[:, 1]
            for i in range(1, len(e_ae)):
                if e_ie[i] > 0:
                    max_ae = max(max_ae, e_ae[i] / e_ie[i])
                    max_sd = max(max_sd, e_sd[i] / e_ie[i])
                    max_ke = max(max_ke, e_ke[i] / e_ie[i])
            if max_ae > 0.01 or max_sd > 0.01 or max_ke > 0.01:
                warning_flag = True
    else:
        if 'RF2' in region.historyOutputs.keys():
            data = np.array(region.historyOutputs['RF2'].data)
            if len(data.shape) > 0:
                for i in range(len(data)):
                    values[i] += data[i, 1]

flags = np.array([warning_flag, periodic_bc_flag], dtype=np.bool_)
np.savetxt(os.path.join(save_path, 'solver_flags.csv'), flags,
           delimiter=',', fmt='%i')
stress_strain_curve = np.stack((strain_spacing, -values[:-1]), axis=1)
np.savetxt(os.path.join(save_path, 'stress_strain.csv'), stress_strain_curve,
           delimiter=',', comments='', header='strain, stress')
np.savetxt(os.path.join(save_path, 'geometry.csv'),
           selected_geometry.reshape(-1), delimiter=',')


# ------------------------------------------------- field frame rasterization

def rasterize_frames():
    """Sample the 11 field frames onto the cad_pixels^2 grid, Lagrangian and
    Eulerian. Direct-ODB re-design of abaqus_script.py:814-1406."""
    n = cad_pixels
    inst = odb.rootAssembly.instances[odb.rootAssembly.instances.keys()[0]]
    node_xy0 = {}
    for nd in inst.nodes:
        node_xy0[nd.label] = (nd.coordinates[0], nd.coordinates[1])
    elems = [(el.label, el.connectivity) for el in inst.elements]

    frames = step.frames
    # field frames are those written at the 11 TimePoints; skip frame 0 if
    # more than 11 frames were written
    sel = list(range(len(frames)))
    if len(sel) > 11:
        sel = sel[-11:]

    def px_of(x, y, wrap_x):
        j = int(np.floor(x * n))
        i = int(np.floor((1.0 - y) * n))
        if wrap_x:
            j %= n
        return i, j

    out_lagr = {k: np.zeros((11, n, n)) for k in
                ('u_1', 'u_2', 's_mises', 's_22', 'strain_energy_dens')}
    geom_lagr = np.zeros((11, n, n), dtype=int)
    out_eul = {k: np.zeros((11, n, n)) for k in
               ('s_mises', 's_22', 'strain_energy_dens')}
    geom_eul = np.zeros((11, n, n), dtype=int)

    for f_i, fr_idx in enumerate(sel):
        fr = frames[fr_idx]
        disp = {}
        for v in fr.fieldOutputs['U'].getSubset(region=inst).values:
            disp[v.nodeLabel] = (v.data[0], v.data[1])
        stress = {}
        for v in fr.fieldOutputs['S'].getSubset(region=inst).values:
            acc = stress.setdefault(v.elementLabel, [0., 0., 0])
            acc[0] += v.mises
            acc[1] += v.data[1]          # S22
            acc[2] += 1
        sener = {}
        if 'SENER' in fr.fieldOutputs.keys():
            for v in fr.fieldOutputs['SENER'].getSubset(region=inst).values:
                acc = sener.setdefault(v.elementLabel, [0., 0])
                acc[0] += v.data
                acc[1] += 1

        cnt_lagr = np.zeros((n, n))
        cnt_eul = np.zeros((n, n))
        for label, conn in elems:
            xs0 = [node_xy0[c][0] for c in conn]
            ys0 = [node_xy0[c][1] for c in conn]
            x0, y0 = np.mean(xs0), np.mean(ys0)
            us = [disp.get(c, (0., 0.)) for c in conn]
            ux = np.mean([u[0] for u in us])
            uy = np.mean([u[1] for u in us])
            sm, s22 = 0., 0.
            if label in stress and stress[label][2] > 0:
                sm = stress[label][0] / stress[label][2]
                s22 = stress[label][1] / stress[label][2]
            se = 0.
            if label in sener and sener[label][1] > 0:
                se = sener[label][0] / sener[label][1]

            i, j = px_of(x0, y0, wrap_x=False)
            if 0 <= i < n and 0 <= j < n:
                geom_lagr[f_i, i, j] = 1
                out_lagr['u_1'][f_i, i, j] += ux
                out_lagr['u_2'][f_i, i, j] += uy
                out_lagr['s_mises'][f_i, i, j] += sm
                out_lagr['s_22'][f_i, i, j] += s22
                out_lagr['strain_energy_dens'][f_i, i, j] += se
                cnt_lagr[i, j] += 1

            ie, je = px_of(x0 + ux, y0 + uy, wrap_x=True)
            if 0 <= ie < n:
                geom_eul[f_i, ie, je] = 1
                out_eul['s_mises'][f_i, ie, je] += sm
                out_eul['s_22'][f_i, ie, je] += s22
                out_eul['strain_energy_dens'][f_i, ie, je] += se
                cnt_eul[ie, je] += 1

        for k in out_lagr:
            nzc = cnt_lagr > 0
            out_lagr[k][f_i][nzc] /= cnt_lagr[nzc]
        for k in out_eul:
            nzc = cnt_eul > 0
            out_eul[k][f_i][nzc] /= cnt_eul[nzc]

    def save(name, arr, fmt=None):
        kw = {'fmt': fmt} if fmt else {}
        np.savetxt(os.path.join(save_path, name),
                   arr.reshape(-1, n), delimiter=',', **kw)

    save('geometry_frames_eul.csv', geom_eul, '%i')
    save('s_mises_frames_eul.csv', out_eul['s_mises'])
    save('s_22_frames_eul.csv', out_eul['s_22'])
    save('strain_energy_dens_frames_eul.csv', out_eul['strain_energy_dens'])
    save('geometry_frames_lagr.csv', geom_lagr, '%i')
    save('u_1_frames_lagr.csv', out_lagr['u_1'])
    save('u_2_frames_lagr.csv', out_lagr['u_2'])
    save('s_mises_frames_lagr.csv', out_lagr['s_mises'])
    save('s_22_frames_lagr.csv', out_lagr['s_22'])
    save('strain_energy_dens_frames_lagr.csv',
         out_lagr['strain_energy_dens'])


if store_frames:
    rasterize_frames()

odb.close()
print('abaqus_model: done (sample %d)' % sample_index)
