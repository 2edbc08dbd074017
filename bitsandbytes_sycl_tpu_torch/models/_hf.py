"""What the family modules share about HuggingFace checkpoints: the
loaders read safetensors through the checkpoint reader, which is not
ported yet, so each ``load_*_from_hf`` raises; the pure config makers
(``_config_from_hf``, a config.json dict in, a config out) are ported."""

from __future__ import annotations


def loader_not_ported(name: str):
    """A ``load_<family>_from_hf`` that raises until the checkpoint reader
    is ported (ROADMAP Queue A #11)."""
    def load(model_dir: str, cfg=None, **kw):
        raise NotImplementedError(
            f"{name}: loading HuggingFace checkpoints is not ported yet (ROADMAP Queue A #11); "
            "build the config with _config_from_hf and the weights with init_*_params or "
            "convert.params_from_jax")

    load.__name__ = name
    load.__doc__ = (f"The JAX package's ``{name}``: raises NotImplementedError until "
                    "the checkpoint reader is ported (ROADMAP Queue A #11).")
    return load
