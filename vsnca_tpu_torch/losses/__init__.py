"""Training losses: overflow, Gram appearance, and the orchestrator."""
