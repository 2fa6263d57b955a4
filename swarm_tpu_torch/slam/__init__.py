from swarm_tpu_torch.slam.closure import (  # noqa: F401
    ClosureState,
    closure_add_pose,
    closure_add_poses_batch,
    closure_add_poses_seq,
    closure_init,
)
from swarm_tpu_torch.slam.scanmatch import MatchResult, match_grids, match_grids_batch  # noqa: F401
from swarm_tpu_torch.slam.posegraph import PoseGraph, gauss_newton, graph_from_trajectory, optimize_graphs_batch  # noqa: F401
from swarm_tpu_torch.slam.merge import MergeResult, merge_local_maps, warp_grid  # noqa: F401
from swarm_tpu_torch.slam.refine import refine_session, reraster_session  # noqa: F401
from swarm_tpu_torch.slam.tridiag import (  # noqa: F401
    block_tridiag_solve,
    structured_gn,
    structured_gn_batch,
)
from swarm_tpu_torch.slam.livemerge import scan_merge  # noqa: F401
from swarm_tpu_torch.slam.scanmatch import WindowMatch, match_scan_window  # noqa: F401
from swarm_tpu_torch.slam.closurematch import (  # noqa: F401
    match_scan_pair,
    match_scan_pairs_batch,
)
from swarm_tpu_torch.slam.joint import (  # noqa: F401
    agent_components,
    joint_refine_session,
    split_closures,
)
