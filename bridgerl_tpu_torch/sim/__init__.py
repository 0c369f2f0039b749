"""The G1 sim layer: the chain, batched FK, motion resampling, the replay
scene and the renderers. Importing it loads no matplotlib or imageio: the
renderers import them when they first draw."""

from .kinematics import BatchedFK, fk_numpy, make_batched_fk, make_fk
from .motion import Motion, load_motion, resample_indices
from .render import (
    debug_camera_views,
    draw_volumetric,
    render_frame,
    render_motion,
    skeleton_segments,
)
from .replay import G1ReplayScene
from .urdf import (
    DEFAULT_ROOT_HEIGHT,
    G1_JOINT_NAMES,
    CollisionPrim,
    JointSpec,
    KinematicChain,
    build_chain,
    load_g1_chain,
    load_g1_collisions,
    parse_urdf_collisions,
    parse_urdf_joints,
    rpy_to_matrix,
)
