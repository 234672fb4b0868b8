"""Engine: model construction, the weight bridge, eval steps, serving.

Submodules are imported where used, so that importing the package does
not pull in every module."""
