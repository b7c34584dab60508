from .models import (LIFConfig, SNNConfig, spike_resnet18,  # noqa: F401
                     spike_resnet50, spike_vgg16)
from .profile import profile_model  # noqa: F401
