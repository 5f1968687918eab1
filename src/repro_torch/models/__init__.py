"""The LM substrate's models: the config schema, the layers, the
mixture of experts (`moe`), multi-head latent attention (`mla`) and the
decoder LM (`lm`)."""
