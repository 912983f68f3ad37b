from .convert import flax_params_to_state_dict, load_reference_checkpoint

__all__ = ["flax_params_to_state_dict", "load_reference_checkpoint"]
