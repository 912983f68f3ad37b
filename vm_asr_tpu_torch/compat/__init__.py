from .convert import (
    flax_disc_variables_to_state_dict,
    flax_params_to_state_dict,
    load_reference_checkpoint,
)

__all__ = ["flax_disc_variables_to_state_dict", "flax_params_to_state_dict",
           "load_reference_checkpoint"]
