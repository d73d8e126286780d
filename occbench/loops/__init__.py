"""The loops that serve a traffic mix, one file each, found by the name
the traffic file gives (`"loop"`)."""
