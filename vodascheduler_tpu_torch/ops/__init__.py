"""Hand-written Hopper kernels for the hot ops of the training plane, and
the plain ops around them. Import from the modules: `flash_attention` names
both a module here and its public function."""
