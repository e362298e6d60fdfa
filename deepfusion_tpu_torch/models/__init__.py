from .fusionnet import FusionNet, FusionNetConfig, PackedFusionNet  # noqa: F401
