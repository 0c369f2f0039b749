from .kinematics import BatchedFK, fk_numpy, make_batched_fk, make_fk
from .urdf import (
    DEFAULT_ROOT_HEIGHT,
    G1_JOINT_NAMES,
    JointSpec,
    KinematicChain,
    load_g1_chain,
    rpy_to_matrix,
)
