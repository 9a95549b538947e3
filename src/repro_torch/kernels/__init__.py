# devices whose tensors take a kernel's plain version: the CPU, and the
# meta device, on which the dry run (launch/dryrun.py) traces shapes only
PLAIN_DEVICES = ("cpu", "meta")
