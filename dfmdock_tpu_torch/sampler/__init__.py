from dfmdock_tpu_torch.sampler.em import EMSampler
