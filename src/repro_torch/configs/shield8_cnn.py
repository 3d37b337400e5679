"""The paper's own model: the canonical 1D-F-CNN deployment config
(the port's ``models/cnn1d.CNNConfig``)."""
from repro_torch.models.cnn1d import CNNConfig

CONFIG = CNNConfig()  # M=1096, (64,128,256) channels, flatten 35,072
