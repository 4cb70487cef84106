"""Deploy stack: the players and the simulator interface (`hardware_player`),
the TCP transport (`transport`), the robot-side devices (`devices`) and the
deploy-scale calibration (`calib`)."""

from .hardware_player import (  # noqa: F401
    DiffusionHardwarePlayer,
    HardwareInterface,
    HardwarePlayer,
    PosPredHardwarePlayer,
    SimInterface,
    StudentHardwarePlayer,
)
