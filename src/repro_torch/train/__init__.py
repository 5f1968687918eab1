"""Step functions over the LM substrate (`steps`), AdamW (`optimizer`) and
the checkpointer (`checkpoint`)."""
