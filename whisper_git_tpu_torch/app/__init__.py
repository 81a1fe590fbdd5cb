"""Application layer (L6): WhisperApp / RepoTab state machine, the
string-keyed action router, and the view composers (L5)."""
