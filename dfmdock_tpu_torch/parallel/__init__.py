"""Multi-GPU docking and training over torch.distributed (the port of
`dfmdock_tpu/parallel`)."""
from dfmdock_tpu_torch.parallel.world import (
    World,
    init_world,
    launch,
    rank_seed,
    spawn,
    world_size_for,
)
