from audio_transformers_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_sum,
    average_gradients,
    build_mesh,
    replicated,
)
