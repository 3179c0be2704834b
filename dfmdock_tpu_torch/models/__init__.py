from dfmdock_tpu_torch.models.score_net import ScoreNet
