"""Loss, P/R metrics, the Adam train step and `fit`, and the checkpoint
bridge."""
