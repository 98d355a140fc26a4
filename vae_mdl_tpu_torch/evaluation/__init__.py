"""The n-importance-sample evaluator with its PSIS k-hat and convergence
curve, and the active-units diagnostic."""
