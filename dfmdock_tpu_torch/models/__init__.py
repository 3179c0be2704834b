from dfmdock_tpu_torch.models.dfmdock import DFMDockModel
from dfmdock_tpu_torch.models.egnn_net import EGNNNet
from dfmdock_tpu_torch.models.score_net import ScoreNet
