"""Inference Config (counterpart of ``paddle_tpu/inference/config.py``;
reference capability: paddle/fluid/inference's analysis config: model
paths, device selection, optimization toggles)."""


class Config:
    def __init__(self, model=None, params=None, model_dir=None):
        # both Config(prog_file, params_file) and Config(model_dir)
        if model is not None and params is None and model_dir is None:
            self._model_dir = model
            self._prog_file = None
        else:
            self._model_dir = model_dir
            self._prog_file = model
        self._params_file = params
        self._use_gpu = True
        self._precision = "float32"
        self._enable_memory_optim = True
        self._batch = 1
        self._extra = {}

    # -- device selection: the port runs on the card unless asked not to
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision_mode=None):
        self._use_gpu = True

    def disable_gpu(self):
        self._use_gpu = False

    def enable_xpu(self, *a, **k):
        self._use_gpu = True

    def enable_custom_device(self, device_type="gpu", device_id=0):
        self._use_gpu = True

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return 0

    # -- precision / optimization toggles
    def enable_tensorrt_engine(self, *a, precision_mode=None, **k):
        # no TensorRT subgraph engine; the precision hint is kept
        if precision_mode in ("Half", 1):
            self._precision = "float16"
        elif precision_mode in ("Bfloat16", 3):
            self._precision = "bfloat16"

    def tensorrt_engine_enabled(self):
        return False

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = flag

    def switch_ir_optim(self, flag=True):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_mkldnn(self):
        pass

    # -- model paths
    def model_dir(self):
        return self._model_dir

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def set_model(self, model, params=None):
        if params is None:
            self._model_dir = model
        else:
            self._prog_file, self._params_file = model, params

    def summary(self):
        return (
            f"Config(model_dir={self._model_dir}, prog={self._prog_file}, "
            f"precision={self._precision}, backend=torch/cuda)"
        )
