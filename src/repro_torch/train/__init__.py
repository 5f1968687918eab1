"""Step functions over the LM substrate (the serving half: `steps`)."""
