"""ctypes bindings for the repo-root native PNG codec."""
