from dfmdock_tpu_torch.geom.rotations import (
    axis_angle_to_matrix,
    compose_axis_angle,
    kabsch,
    matrix_to_axis_angle,
    matrix_to_rotation_6d,
    random_rotation_matrix,
    rotation_6d_to_matrix,
    skew,
)
