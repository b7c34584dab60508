from .neurons import LIFConfig, lif_rollout, lif_step, spike  # noqa: F401
from .models import (SNNConfig, SpikingNet, from_reference_params,  # noqa: F401
                     init_model, init_state, model_rollout, model_specs,
                     model_step, spike_resnet18, spike_resnet50, spike_vgg16,
                     to_reference_params)
from .profile import profile_model  # noqa: F401
