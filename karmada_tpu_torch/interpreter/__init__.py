from karmada_tpu_torch.interpreter.interpreter import (  # noqa: F401
    Customization,
    ResourceInterpreter,
)
