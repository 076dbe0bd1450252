"""The framework layer of the port (counterpart of
``paddle_tpu/framework``): the dtype names and the default dtype
(``dtype``), the runtime flag registry (``flags``) and the per-op NaN/Inf
check behind ``FLAGS_check_nan_inf`` (``nan_inf``). The tensor core and
the random state come with ROADMAP.md section 1 item 6."""
from . import dtype, flags, nan_inf
from .dtype import convert_dtype, get_default_dtype, set_default_dtype
from .flags import get_flags, set_flags

# FLAGS_check_nan_inf=1 in the environment: the importing thread checks
nan_inf.sync_mode()

__all__ = ["dtype", "flags", "nan_inf", "convert_dtype", "get_default_dtype",
           "set_default_dtype", "get_flags", "set_flags"]
