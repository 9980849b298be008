"""One driver a traffic kind; a cell's workload file names its kind and
holds its parameters."""
