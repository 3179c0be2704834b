from dfmdock_tpu_torch.geom.rotations import (
    axis_angle_to_matrix,
    compose_axis_angle,
    matrix_to_axis_angle,
    random_rotation_matrix,
)
