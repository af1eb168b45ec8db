"""The data path: synthetic corpora, preprocessing into features, and the
bucketed batch feeder of the train loop."""
