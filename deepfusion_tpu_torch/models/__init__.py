from .fusionnet import FusionNet, FusionNetConfig  # noqa: F401
