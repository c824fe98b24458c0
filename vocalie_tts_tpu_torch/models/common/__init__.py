"""Building blocks shared by the model families."""
