from dfmdock_tpu_torch.diffusion.r3 import R3Diffuser
from dfmdock_tpu_torch.diffusion.so3 import SO3Diffuser
