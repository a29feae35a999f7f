"""Loss and metric helpers of the port."""
