"""Data parallelism (``mesh.py``) and context parallelism (``context.py``) of
the port over ``torch.distributed``. The context-parallel entry points sit
above the models, which import ``mesh.py``, so they load on first use."""
from mdvit_tpu_torch.parallel.mesh import halo_exchange_rows  # noqa: F401

_CONTEXT = ("ContextMesh", "make_context_mesh", "make_context_parallel_train_step",
            "make_dp_context_mesh", "model_apply_context_parallel",
            "stage_apply_context_parallel")


def __getattr__(name: str):
    if name in _CONTEXT:
        from mdvit_tpu_torch.parallel import context

        return getattr(context, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
