"""The LM substrate's models: the config schema, the layers, the
mixture of experts (`moe`), multi-head latent attention (`mla`), the
RG-LRU (`rglru`) and Mamba-2 SSD (`ssd`) blocks, and the decoder LM
(`lm`)."""
