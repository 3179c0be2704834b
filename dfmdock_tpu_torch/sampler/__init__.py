from dfmdock_tpu_torch.sampler.em import EMSampler
from dfmdock_tpu_torch.sampler.picard import PicardSampler
