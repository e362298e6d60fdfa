from .fusionnet import FusionNet, FusionNetConfig, PackedFusionNet  # noqa: F401
from .googlenet import GoogLeNet, GoogLeNetConfig  # noqa: F401
from .mobilenetv2 import MobileNetV2, MobileNetV2Config  # noqa: F401
from .resfusion import ResFusionNet, ResFusionNetConfig  # noqa: F401
from .resnet50 import ResNet50, ResNet50Config  # noqa: F401
from .vggfusion import VGGFusion, VGGFusionConfig  # noqa: F401
