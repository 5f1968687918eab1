"""The LM substrate's models: the config schema, the layers and the
dense decoder LM (`lm`)."""
