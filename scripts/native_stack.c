/* A SIGSEGV handler that prints the native frames of a crash: the library
 * and offset of the faulting instruction, then the unwound stack.  It hands
 * the signal on to the handler it replaced (Python's faulthandler, which
 * prints the Python stacks): the faulting instruction runs again into it.
 * Built and installed by scripts/smoke_loop.py --native-stack. */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <ucontext.h>
#include <unistd.h>

static struct sigaction previous;
static char alt_stack[1 << 16];

static void say(const char *s) {
    ssize_t n = write(2, s, strlen(s));
    (void)n;
}

static void where(const char *what, void *pc) {
    char line[512];
    Dl_info d;
    memset(&d, 0, sizeof d);
    dladdr(pc, &d);
    snprintf(line, sizeof line, "%s %p in %s +0x%lx %s\n", what, pc,
             d.dli_fname ? d.dli_fname : "?",
             (unsigned long)((char *)pc - (char *)d.dli_fbase),
             d.dli_sname ? d.dli_sname : "");
    say(line);
}

static void on_segv(int sig, siginfo_t *info, void *context) {
    char line[128];
    void *frames[64];
    ucontext_t *uc = (ucontext_t *)context;
    snprintf(line, sizeof line, "\nnative SIGSEGV: fault address %p\n", info->si_addr);
    say(line);
    where("  pc", (void *)uc->uc_mcontext.gregs[REG_RIP]);
    int n = backtrace(frames, 64);
    for (int i = 0; i < n; i++)
        where("  frame", frames[i]);
    say("end of the native stack\n");
    (void)sig;
    sigaction(SIGSEGV, &previous, 0);
}

void native_stack_install(void) {
    void *warm[1];
    backtrace(warm, 1); /* load the unwinder now, not inside the handler */
    stack_t ss;
    memset(&ss, 0, sizeof ss);
    ss.ss_sp = alt_stack;
    ss.ss_size = sizeof alt_stack;
    sigaltstack(&ss, 0);
    struct sigaction sa;
    memset(&sa, 0, sizeof sa);
    sa.sa_sigaction = on_segv;
    sa.sa_flags = SA_SIGINFO | SA_ONSTACK;
    sigaction(SIGSEGV, &sa, &previous);
}
