"""The 5000-importance-sample evaluator."""
