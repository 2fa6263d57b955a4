from swarm_tpu_torch.models.ekf import EkfState, ekf_init, ekf_predict, ekf_update  # noqa: F401
from swarm_tpu_torch.models.landmarks import (  # noqa: F401
    LM_CORNER_L,
    LM_CORNER_R,
    LM_CORRIDOR,
    LM_DEAD_END,
    LM_NONE,
    LM_OPEN,
    detect_landmark_fw,
    detect_landmark_sim,
)
from swarm_tpu_torch.models.sensors import (  # noqa: F401
    SensorNoise,
    draw_median3_noise,
    draw_sensor_noise,
    sense_4way,
    sense_4way_median3,
    sense_true,
)
from swarm_tpu_torch.models.odometry import drift_integrate, encoder_emit, firmware_odometry_step  # noqa: F401
from swarm_tpu_torch.models.scan import cmd_vel_drive, scan_angles, sense_scan  # noqa: F401
from swarm_tpu_torch.models.nav import NavCommand, NavParams, NavState, nav_init, nav_step  # noqa: F401
